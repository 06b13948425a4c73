"""dspeed-tpu tutorial on the PyTorch / CUDA port: a narrated walk-through.

The port's counterpart of ``examples/quickstart.py``: the same seven steps,
in the same order, with the same physics checks, run by
``dspeed_tpu_torch`` (an NVIDIA card by default; the CPU when asked). It
imports neither JAX nor the JAX package. Run it from the repository's root
(or with the package installed, without ``PYTHONPATH``):

    PYTHONPATH=. python examples/quickstart_torch.py                 # the card
    PYTHONPATH=. python examples/quickstart_torch.py --device cpu    # anywhere

Covered, in order:

1. writing a raw-tier LH5 file of synthetic HPGe pulses,
2. what's inside a DSP config (processors, db parameters, outputs),
3. bulk production with ``build_dsp``,
4. reading the DSP tier back and checking the physics,
5. checked mode: halting on a bad event with the exact entry number,
6. drawing annotated waveforms with the ``WaveformBrowser``,
7. the in-memory API: building and running a chain without files.

Steps 1, 3, 4 and 6 read or write LH5 files and need ``h5py``; step 6
draws and needs ``matplotlib``. Steps 2, 5 (``checked_in_memory``) and 7
need neither. Every step that runs a chain takes ``device`` (default
``"cuda"``): without a card it raises, it never falls back to the CPU.
"""

import argparse
import os
import tempfile

import numpy as np

import dspeed_tpu_torch as dspeed
from dspeed_tpu_torch import lh5

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "..", "configs", "hpge-energy-timing.yaml")
DB = {"pz": {"tau": 27460.5}}  # per-detector calibration database slice
BAD_ENTRY = 27  # the event whose pick-off index is out of range (step 5)


def make_waveforms(n=256, nsamp=4096, seed=7):
    """HPGe-like pulses: baseline, linear rise, exponential decay."""
    rng = np.random.default_rng(seed)
    tau = 27460.5  # decay constant, samples
    amp = rng.uniform(500, 30000, n)
    t0 = rng.integers(950, 1050, n)
    rt = rng.integers(40, 150, n)
    bl = rng.uniform(14000, 16000, n)
    t = np.arange(nsamp)[None, :]
    rise = np.clip((t - t0[:, None]) / rt[:, None], 0, 1)
    decay = np.where(
        t > t0[:, None] + rt[:, None],
        np.exp(-(t - t0[:, None] - rt[:, None]) / tau),
        1.0,
    )
    wf = bl[:, None] + amp[:, None] * rise * decay
    wf += rng.normal(0, 3, (n, nsamp))
    return wf.astype("float32"), amp, bl


def raw_table(wf, bl=None, **cols):
    """A raw-tier channel table: a WaveformTable (values + t0 + dt, each
    with units), the DAQ's baseline and any other per-event columns."""
    tb = {"waveform": lh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns")}
    if bl is not None:
        tb["baseline"] = lh5.Array(np.asarray(bl, "float32"))
    tb.update(cols)
    return lh5.Table(tb)


# ---------------------------------------------------------------- step 1
def step1_write_raw(workdir, n=256):
    """A raw-tier file is LH5: an HDF5 file whose groups carry LGDO type
    attributes. The port writes it with its own copy of the LH5 layer."""
    raw_file = os.path.join(workdir, "demo_raw.lh5")
    wf, amp, bl = make_waveforms(n)
    tb = raw_table(wf, bl)
    lh5.write(tb, "det01/raw", raw_file)
    print(f"[1] wrote {len(tb)} waveforms to {raw_file}")
    return raw_file, amp


# ---------------------------------------------------------------- step 2
def step2_inspect_config():
    """A DSP config is a dict (JSON or YAML) with two keys: ``outputs``
    (what lands in the DSP file) and ``processors`` (one node per derived
    variable). The port reads the JAX package's configs as they are: a
    node's ``module: dspeed_tpu.processors`` names the port's processor of
    the same name. ``db.`` prefixes pull per-channel values from the
    database dict; units in arg strings ("2*us") become samples at build
    time."""
    import yaml

    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    node = cfg["processors"]["wf_pz"]
    print(f"[2] config: {len(cfg['processors'])} processors, "
          f"{len(cfg['outputs'])} outputs")
    print(f"    wf_pz node: function={node['function']} args={node['args']}")
    assert "db.pz.tau" in str(node["args"])
    return cfg


# ---------------------------------------------------------------- step 3
def step3_production(raw_file, workdir, device="cuda"):
    """``build_dsp`` is the bulk driver: it reads the raw file in chunks,
    builds the chain once per (config, shape) and keeps it in a cache,
    copies each chunk to the card while the last one runs, launches the
    fused kernels, and writes the DSP tier behind it. The database maps
    channel names to calibration slices."""
    dsp_file = os.path.join(workdir, "demo_dsp.lh5")
    dspeed.build_dsp(raw_file, dsp_file, CONFIG, database={"det01": DB},
                     write_mode="r", device=device)
    print(f"[3] production on {device} complete -> {dsp_file}")
    return dsp_file


# ---------------------------------------------------------------- step 4
def check_energies(dsp, amp):
    """trapEmax must recover the injected amplitudes to well under a
    percent (trap filter ballistic deficit on these synthetic rise times).
    ``dsp`` is the DSP table (read from a file or returned in memory).
    Returns the worst relative error."""
    trapEmax = np.asarray(dsp["trapEmax"].nda)
    rel = np.abs(trapEmax - amp) / amp
    rise = np.nanmedian(np.asarray(dsp["tp_90"].nda) - np.asarray(dsp["tp_10"].nda))
    print(f"    {len(list(dsp.keys()))} columns; trapEmax recovers amplitudes to "
          f"{rel.max():.2%} worst-case; median tp_90-tp_10 rise {rise:.0f} "
          f"{dsp['tp_90'].attrs['units']}")
    assert rel.max() < 0.02, "energy reconstruction off"
    assert dsp["tp_50"].attrs["units"] == "ns"
    return rel.max()


def step4_read_back(dsp_file, amp):
    """The DSP tier is plain LH5: every output column with its units."""
    dsp = lh5.read("det01/dsp", dsp_file)
    print("[4] read back the DSP tier:")
    return check_energies(dsp, amp)


# ---------------------------------------------------------------- step 5
def checked_config():
    """One pick-off: ``picked`` = waveform[pickidx]."""
    return {
        "outputs": ["picked"],
        "processors": {
            "picked": {
                "function": "get",
                "module": "dspeed_tpu.processors",
                "args": ["waveform", "pickidx", "picked"],
            }
        },
    }


def checked_table(n=40, bad=BAD_ENTRY, wf=None):
    """``n`` events (of ``wf``, else of ``make_waveforms``) that pick sample
    100, but event ``bad``, which picks outside the waveform."""
    wf = make_waveforms(n)[0] if wf is None else wf[:n]
    idx = np.full(n, 100, "int64")
    idx[bad] = 99999
    return raw_table(wf, pickidx=lh5.Array(idx))


def checked_in_memory(tb, device="cuda", bad=BAD_ENTRY):
    """Step 5's chain work on an in-memory table ``tb`` (``checked_table``),
    which ``build_dsp`` runs as one chunk: by default the bad event is NaN
    and everything else processes; with ``checked=True`` the same table
    halts with ``DSPFatal``, naming the processor and the bad event's entry.
    Returns the error."""
    from dspeed_tpu_torch.errors import DSPFatal

    out = dspeed.build_dsp(tb, dsp_config=checked_config(), device=device)
    picked = np.asarray(out["picked"].nda)
    assert np.isnan(picked[bad]) and np.isfinite(np.delete(picked, bad)).all()
    try:
        dspeed.build_dsp(tb, dsp_config=checked_config(), device=device,
                         checked=True)
    except DSPFatal as e:
        assert e.wf_range == (bad, bad), e.wf_range
        return e
    raise AssertionError("checked mode did not raise")


def step5_checked_mode(workdir, device="cuda"):
    """By default an event whose data violates a kernel precondition (here:
    an out-of-range pick-off index) silently becomes NaN, the chain-wide
    invalid-event convention. With ``checked=True`` production instead
    halts like the reference, naming the processor and the exact global
    entry. The port carries each checker's flags beside the outputs and
    scans them when the chunk comes back from the card."""
    from dspeed_tpu_torch.errors import DSPFatal

    raw_file = os.path.join(workdir, "checked_raw.lh5")
    lh5.write(checked_table(), "det01/raw", raw_file)
    dsp_file = os.path.join(workdir, "checked_dsp.lh5")
    # default: event 27 is NaN, everything else processes
    dspeed.build_dsp(raw_file, dsp_file, checked_config(), write_mode="r",
                     buffer_len=16, device=device)
    picked = lh5.read("det01/dsp", dsp_file)["picked"].nda
    assert np.isnan(picked[BAD_ENTRY]) and np.isfinite(picked[0])
    # checked: the same file halts with the exact entry
    try:
        dspeed.build_dsp(raw_file, dsp_file, checked_config(), write_mode="r",
                         buffer_len=16, checked=True, device=device)
    except DSPFatal as e:
        print(f"[5] checked mode halted: '{e.args[0]}' at entries "
              f"{e.wf_range} in {e.processor}")
        assert e.wf_range == (BAD_ENTRY, BAD_ENTRY)
        return e
    raise AssertionError("checked mode did not raise")


# ---------------------------------------------------------------- step 6
def step6_browser(raw_file, workdir, device="cuda"):
    """The WaveformBrowser runs the chain per entry on ``device`` and draws
    any intermediate variable (raw waveform, pole-zero corrected, trap
    output) with legends evaluated from chain variables. Finding entries
    needs no matplotlib; drawing does. Headless here; interactively it
    pages with draw_next()."""
    import matplotlib

    matplotlib.use("Agg")
    from dspeed_tpu_torch.vis import WaveformBrowser

    wb = WaveformBrowser(
        raw_file,
        "det01/raw",
        dsp_config=CONFIG,
        database=DB,
        lines=["waveform", "wf_pz"],
        legend=["trapEmax = {trapEmax:.0f}"],
        device=device,
    )
    wb.draw_entry([3, 5])
    png = os.path.join(workdir, "waveforms.png")
    wb.save_figure(png)
    print(f"[6] browser drew entries 3,5 -> {png}")
    assert os.path.getsize(png) > 1000
    return png


# ---------------------------------------------------------------- step 7
def step7_in_memory(device="cuda", n=32, events=None):
    """No files needed: build_processing_chain works on an in-memory Table,
    and the chain object is callable. The chain holds its steps (the fused
    kernels among them) for the table's shape; calling it copies the table
    to ``device``, runs the steps and fetches the outputs. ``events`` is
    ``make_waveforms``' output, where the caller has it already."""
    from dspeed_tpu_torch.processing_chain import build_processing_chain

    wf, amp, bl = make_waveforms(n) if events is None else events
    tb = raw_table(wf, bl)
    chain, _, tb_out = build_processing_chain(CONFIG, tb, db_dict=DB, device=device)
    chain(tb, tb_out)
    e = np.asarray(tb_out["trapEmax"].nda)
    rel = np.abs(e - amp) / amp
    print(f"[7] in-memory chain on {device}: {len(list(tb_out.keys()))} outputs, "
          f"{len(wf)} events, trapEmax max rel err {rel.max():.2%}")
    assert rel.max() < 0.02
    return tb_out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    workdir = tempfile.mkdtemp(prefix="dspeed_tpu_torch_demo_")
    raw_file, amp = step1_write_raw(workdir)
    step2_inspect_config()
    dsp_file = step3_production(raw_file, workdir, args.device)
    step4_read_back(dsp_file, amp)
    step5_checked_mode(workdir, args.device)
    step6_browser(raw_file, workdir, args.device)
    step7_in_memory(args.device)
    print(f"tutorial complete; artifacts in {workdir}")


if __name__ == "__main__":
    main()
