"""Multi-channel processing over a device mesh, on the PyTorch / CUDA port.

The port's counterpart of ``examples/multichannel_spmd.py``: the four-step
trapezoid chain over a stacked (channel, event) batch, one dispatch per
chunk, sharded over a ``("channel", "data")`` mesh of
``dspeed_tpu_torch.parallel``. It imports neither JAX nor the JAX package.
Where the JAX package lays one program over all devices, the port runs one
process per card (``torch.distributed``: NCCL between cards, gloo on the
CPU): each rank runs its block of the stacked rows and the outputs are
gathered back, so every rank holds the whole (channel, event) result. On
one card the world size is 1 and the channels stack on that card. Run it
from the repository's root:

    PYTHONPATH=. python examples/multichannel_torch.py                 # one card
    PYTHONPATH=. torchrun --nproc-per-node 2 examples/multichannel_torch.py
    PYTHONPATH=. python examples/multichannel_torch.py --device cpu    # gloo

Everything runs in memory (no ``h5py``); ``run`` takes ``device`` (default
``"cuda"``): without a card it raises, it never falls back to the CPU.
"""

import argparse
import contextlib
import math
import os
import socket

import numpy as np
import torch.distributed as dist

from dspeed_tpu_torch import lh5
from dspeed_tpu_torch.parallel import (
    initialize_distributed,
    make_mesh,
    stacked_chain,
    stacked_dispatch,
    stacked_results,
)

TAU = 4000.0  # the synthetic pulses' decay, samples
CONFIG = {
    "outputs": ["trapEmax"],
    "processors": {
        "wf_blsub": {
            "function": "bl_subtract",
            "module": "dspeed_tpu.processors",
            "args": ["waveform", "baseline", "wf_blsub"],
        },
        "wf_pz": {
            "function": "pole_zero",
            "module": "dspeed_tpu.processors",
            "args": ["wf_blsub", f"{TAU}", "wf_pz"],
        },
        "wf_trap": {
            "function": "trap_norm",
            "module": "dspeed_tpu.processors",
            "args": ["wf_pz", "100", "50", "wf_trap"],
        },
        "trapEmax": {
            "function": "amax",
            "module": "numpy",
            "args": ["wf_trap", 1, "trapEmax"],
            "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]},
        },
    },
}


def make_channels(n_chan=2, n_ev=64, nsamp=1024, seed=0):
    """Synthetic per-channel batches (in production: one LH5 table per
    channel), as ``multichannel_spmd.py`` makes them: ``(wf, amp, bl)``
    with the ``n_chan * n_ev`` events channel after channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(nsamp)[None, :]
    t0 = rng.integers(200, 300, (n_chan * n_ev, 1))
    amp = rng.uniform(1000, 20000, (n_chan * n_ev, 1))
    wf = 15000.0 + amp * np.clip((t - t0) / 20, 0, 1) * np.exp(
        -np.clip(t - t0 - 20, 0, None) / TAU
    )
    wf = (wf + rng.normal(0, 3, wf.shape)).astype("float32")
    bl = np.full(n_chan * n_ev, 15000.0, "float32")
    return wf, amp[:, 0], bl


def table(wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(
            values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns"
        ),
        "baseline": lh5.Array(bl),
    })


@contextlib.contextmanager
def distributed(device="cuda"):
    """This process in its group: under ``torchrun`` the group it names
    (one rank a card), else a group of one on a free local port; the group
    is left as it was found."""
    if dist.is_initialized():
        yield
        return
    if "RANK" in os.environ:  # torchrun
        initialize_distributed(device=device)
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        initialize_distributed(device=device, init_method=f"tcp://localhost:{port}",
                               rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_shape(n_chan, world):
    """The ``("channel", "data")`` layout of ``world`` ranks: the channels
    over as many ranks as divide both, the events over the rest."""
    c = math.gcd(n_chan, world)
    return {"channel": c, "data": world // c}


def run(device="cuda", n_chan=2, n_ev=64, nsamp=1024, seed=0):
    """The stacked chain over the mesh: one table a channel, stacked into
    one ``(n_chan, n_ev)`` dispatch, each rank its block of it. Returns
    ``(trapEmax of shape (n_chan, n_ev), the injected amplitudes, the mesh's
    shape)``."""
    wf, amp, bl = make_channels(n_chan, n_ev, nsamp, seed)
    tables = [table(wf[c * n_ev:(c + 1) * n_ev], bl[c * n_ev:(c + 1) * n_ev])
              for c in range(n_chan)]
    with distributed(device):
        shape = mesh_shape(n_chan, dist.get_world_size())
        mesh = make_mesh(shape, device=device)
        # the chain of a channel's chunk, sharded over the mesh's
        # ("channel", "data") axes; then the stack of every channel's chunk
        # in one dispatch, and its outputs split per channel
        chain, _, _ = stacked_chain(CONFIG, tables[0], device=device, mesh=mesh)
        pending, n = stacked_dispatch(chain, tables, n_ev)
        results = stacked_results(chain, pending)
    key = next(k for k in results[0] if k.startswith("trapEmax"))
    te = np.stack([r[key][:n] for r in results])
    return te, amp.reshape(n_chan, n_ev), shape


def unsharded(device="cuda", n_chan=2, n_ev=64, nsamp=1024, seed=0):
    """trapEmax of the same events through one chain, no mesh and no stack
    (``(n_chan, n_ev)``): what every rank's stacked result must equal."""
    from dspeed_tpu_torch.processing_chain import build_processing_chain

    wf, _, bl = make_channels(n_chan, n_ev, nsamp, seed)
    tb = table(wf, bl)
    chain, _, _ = build_processing_chain(CONFIG, tb, device=device)
    return np.asarray(chain(tb)["trapEmax"].nda).reshape(n_chan, n_ev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    te, amp, shape = run(args.device)
    print(f"mesh {shape} -> trapEmax shape {te.shape}, mean rel err vs injected: "
          f"{np.nanmean(np.abs(te - amp) / amp):.3%}")
    same = te.tobytes() == unsharded(args.device).tobytes()
    print(f"equal to the unsharded chain bit for bit: {same}")
    assert same


if __name__ == "__main__":
    main()
