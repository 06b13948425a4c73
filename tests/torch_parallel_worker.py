"""One gloo rank of ``tests/test_torch_parallel.py``'s four-rank run: every
multi-rank scenario in one process group, results pickled per rank.

    python tests/torch_parallel_worker.py RANK WORLD STORE WORKDIR

It imports neither JAX nor the JAX package. ``WORKDIR`` holds the inputs the
test wrote (``inputs.pkl``, ``multi_raw.lh5``); each rank writes
``rank<r>.pkl``.
"""

import copy
import os
import pickle
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from torch_flagship import flagship_config  # noqa: E402

from dspeed_tpu_torch import build_dsp, lh5  # noqa: E402
from dspeed_tpu_torch.parallel import (  # noqa: E402
    build_dsp_stacked, make_mesh, shard_chain, sp_convolve_same,
)
from dspeed_tpu_torch.parallel import bulk, conv  # noqa: E402
from dspeed_tpu_torch.parallel.mesh import initialize_distributed  # noqa: E402
from dspeed_tpu_torch.processing_chain import build_processing_chain  # noqa: E402

TAU = {"pz": {"tau": 27460.5}}


def conv_chain_config():
    """The JAX package's sequence-parallel test chain
    (``tests/test_parallel.py``): a Gaussian kernel, then ``fft_convolve_wf``
    and ``convolve_wf`` in mode ``'s'``."""
    return {
        "outputs": ["wf_smooth", "wf_direct"],
        "processors": {
            "kern": {"function": "gaussian_filter1d",
                     "module": "dspeed_tpu.processors",
                     "args": ["4", "3.0", "kern(25, 'f')"]},
            "wf_smooth": {"function": "fft_convolve_wf",
                          "module": "dspeed_tpu.processors",
                          "args": ["waveform", "kern", "'s'",
                                   "wf_smooth(len(waveform), 'f')"]},
            "wf_direct": {"function": "convolve_wf",
                          "module": "dspeed_tpu.processors",
                          "args": ["waveform", "kern", "'s'",
                                   "wf_direct(len(waveform), 'f')"]},
        },
    }


def long_aux_config():
    """``tests/test_parallel.py``'s long-auxiliary chain: a convolution of
    the waveform and the maximum of an input four times as long."""
    return {
        "outputs": ["wf_smooth", "aux_max"],
        "processors": {
            "kern": {"function": "gaussian_filter1d",
                     "module": "dspeed_tpu.processors",
                     "args": ["4", "3.0", "kern(25, 'f')"]},
            "wf_smooth": {"function": "convolve_wf",
                          "module": "dspeed_tpu.processors",
                          "args": ["waveform", "kern", "'s'",
                                   "wf_smooth(len(waveform), 'f')"]},
            "aux_max": {"function": "amax", "module": "numpy",
                        "args": ["longaux", 1, "aux_max"],
                        "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]}},
        },
    }


def wf_table(wf, **cols):
    tb = lh5.Table({"waveform": lh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns")})
    for k, v in cols.items():
        tb.add_field(k, v)
    return tb


class Counted:
    """Counts calls of ``mod.name`` while it is installed."""

    def __init__(self, mod, name):
        self.mod, self.name, self.n = mod, name, 0
        self.orig = getattr(mod, name)

        def fn(*a, **k):
            self.n += 1
            return self.orig(*a, **k)

        setattr(mod, name, fn)

    def close(self):
        setattr(self.mod, self.name, self.orig)


def columns(tb, keys):
    return {k: np.array(tb[k].nda) for k in keys}


def main():
    rank, world, store, work = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                sys.argv[4])
    torch.set_num_threads(1)
    initialize_distributed(device="cpu", store=dist.FileStore(store, world),
                           rank=rank, world_size=world,
                           timeout=timedelta(seconds=180))
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    res = {}

    # -- sp_convolve_same over {"sp": 4}, halo exchanges counted -------------
    mesh_sp = make_mesh({"sp": world}, device="cpu")
    hops = Counted(dist, "batch_isend_irecv")
    for m, taps in inp["taps"].items():
        res[f"sp_conv_{m}"] = sp_convolve_same(inp["sp_w"], taps, mesh_sp).numpy()
    res["sp_hops"] = hops.n
    res["sp_small"] = sp_convolve_same(inp["sp_w"][:2, :512], inp["taps"][15][:9],
                                       mesh_sp).numpy()
    hops.close()
    for args in ((inp["sp_w"][:, :1022], inp["taps"][15]),
                 (inp["sp_w"][:, :32], inp["taps"][33])):
        try:
            sp_convolve_same(args[0], args[1], mesh_sp)
            res.setdefault("sp_errors", []).append(None)
        except ValueError as e:
            res.setdefault("sp_errors", []).append(str(e))

    # -- a sample-sharded chain over {"data": 2, "sp": 2} ---------------------
    mesh_dsp = make_mesh({"data": 2, "sp": 2}, device="cpu")
    tb = wf_table(inp["seq_wf"])
    chain, _, _ = build_processing_chain(conv_chain_config(), tb, device="cpu")
    chain.set_sharding(mesh_dsp, batch_axes=("data",), sample_axis="sp")
    routes = Counted(conv, "sp_convolve_same_traced")
    out = chain(tb)
    res["seq_chain"] = columns(out, ["wf_smooth", "wf_direct"])
    res["seq_halo_routes"] = routes.n
    routes.close()

    # -- the long auxiliary input keeps its samples whole --------------------
    tb = wf_table(inp["aux_wf"], longaux=lh5.ArrayOfEqualSizedArrays(nda=inp["aux"]))
    chain, _, _ = build_processing_chain(long_aux_config(), tb, device="cpu")
    chain.set_sharding(mesh_dsp, batch_axes=("data",), sample_axis="sp")
    chain._link_inputs(tb)
    inputs, n = chain._gather_inputs(0, chain._buffer_len)
    cut_in, cut = chain._cut_chunk(inputs, n, 1)
    res["aux_split"] = sorted(
        ("waveform" if k.startswith("waveform") else k.split("#")[0])
        for k in cut.split)
    res["aux_shapes"] = {k.split("#")[0]: v.shape for k, v in cut_in.items()}
    res["aux_chain"] = columns(chain(tb), ["wf_smooth", "aux_max"])

    # -- the flagship stacked over {"channel": 2, "data": 2} ------------------
    mesh_cd = make_mesh({"channel": 2, "data": 2}, device="cpu")
    tabs = [wf_table(w, baseline=lh5.Array(b)) for w, b in inp["stack"]]
    chain, _, tb_out = build_processing_chain(flagship_config(), tabs[0],
                                              db_dict=TAU, device="cpu")
    shard_chain(chain, mesh_cd, batch_axes=("channel", "data"))
    pending, n = bulk.stacked_dispatch(chain, tabs, len(inp["stack"][0][0]))
    res["stack_lead"] = pending[3]
    tb_outs = [copy.deepcopy(tb_out) for _ in tabs]
    bulk.write_channels(chain, bulk.stacked_results(chain, pending), tb_outs, n)
    res["stack"] = [{k: v[:n] for k, v in columns(t, flagship_config()["outputs"]).items()}
                    for t in tb_outs]

    # -- build_dsp_stacked over the mesh, from the file; rank 0 writes --------
    out_mesh = os.path.join(work, "multi_mesh_dsp.lh5")
    build_dsp_stacked(inp["raw"], out_mesh, flagship_config(), inp["chans"],
                      mesh=mesh_cd, database=TAU, buffer_len=16, device="cpu",
                      write_mode="r")
    dist.barrier()

    # -- without a mesh: channels round-robin, more ranks than channels ------
    out_rr = os.path.join(work, "multi_rr_dsp.lh5")
    got = build_dsp_stacked(inp["raw"], None, flagship_config(), inp["chans"][:3],
                            database=TAU, buffer_len=16, device="cpu",
                            outputs=["trapEmax", "tp_50"])
    res["rr_struct"] = {ch: columns(got[ch]["dsp"], ["trapEmax", "tp_50"])
                        for ch in got}
    build_dsp_stacked(inp["raw"], out_rr, flagship_config(), inp["chans"][:3],
                      database=TAU, buffer_len=16, device="cpu",
                      outputs=["trapEmax", "tp_50"], write_mode="r")
    res["rr_file"] = os.path.isfile(bulk._bdsp().per_host_out_path(out_rr, rank))

    # -- build_dsp, one channel table a rank ----------------------------------
    db = {ch.split("/")[0]: TAU for ch in inp["chans"]}
    out_bd = os.path.join(work, "multi_bd_dsp.lh5")
    build_dsp(inp["raw"], out_bd, flagship_config(), database=db, buffer_len=16,
              device="cpu", outputs=["trapEmax"], write_mode="r")

    dist.barrier()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
