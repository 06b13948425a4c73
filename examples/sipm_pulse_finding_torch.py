"""dspeed-tpu tutorial 2 on the PyTorch / CUDA port: SiPM pulse finding with
variable-length outputs.

The port's counterpart of ``examples/sipm_pulse_finding.py``: the same
steps, in the same order, with the same checks, run by ``dspeed_tpu_torch``
(an NVIDIA card by default; the CPU when asked). It imports neither JAX nor
the JAX package. Each SiPM waveform carries an *unknown number* of photon
pulses, so the trigger times and per-pulse energies are ragged:
smoothing, current derivative, a noise-adaptive peak search whose threshold
comes from a histogram of the waveform's own noise, SNR filtering, and
VectorOfVectors (VoV) output columns. Run it from the repository's root:

    PYTHONPATH=. python examples/sipm_pulse_finding_torch.py                # the card
    PYTHONPATH=. python examples/sipm_pulse_finding_torch.py --device cpu   # anywhere

Steps 2 to 4 write and read LH5 files and need ``h5py``; their chain work
also runs on in-memory tables (``produce``, ``check_pulses``,
``checked_in_memory``), which need nothing but the port. Every step that
runs a chain takes ``device`` (default ``"cuda"``): without a card it
raises, it never falls back to the CPU.
"""

import argparse
import os
import tempfile

import numpy as np

import dspeed_tpu_torch as dspeed
from dspeed_tpu_torch import lh5

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "..", "configs", "sipm-pulse-finding.yaml")
DT = 16.0  # ns per sample


# ---------------------------------------------------------------- step 1
def make_sipm_waveforms(n=128, nsamp=1024, seed=3):
    """SiPM-like traces: flat noisy baseline + a Poisson number of fast
    pulses (sharp rise, ~80-sample exponential tail) at random times.
    Returns the waveforms AND the truth (pulse times per event) so the
    found triggers can be validated against it."""
    rng = np.random.default_rng(seed)
    t = np.arange(nsamp)[None, :]
    wf = rng.normal(0.0, 1.0, (n, nsamp))
    n_pulse = rng.poisson(2.0, n)
    truth = []
    for i in range(n):
        t0s = np.sort(rng.uniform(50, nsamp - 50, n_pulse[i]))
        for t0 in t0s:
            a = rng.uniform(20, 200)
            wf[i] += a * np.exp(-np.abs(t[0] - t0) / np.where(t[0] > t0, 80, 3))
        truth.append(t0s)
    return wf.astype("float32"), truth


def raw_table(wf):
    return lh5.Table({"waveform": lh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=DT, dt_units="ns")})


# ---------------------------------------------------------------- step 2
def produce(tb, device="cuda", checked=False):
    """The chain on an in-memory raw table: the DSP table, its ragged
    columns as VectorOfVectors."""
    return dspeed.build_dsp(tb, dsp_config=CONFIG, device=device, checked=checked)


def step2_production(workdir, device="cuda", n=128):
    """Variable-length outputs are declared in the config with
    ``vector_len``: the peak search fills fixed NaN-padded slot arrays on
    the card (one row of slots an event, so each step is one batched launch)
    plus a per-event count, and the VoV output manager packs them into a
    ragged VectorOfVectors column on the host as the chunk comes back: the
    same dense-on-the-card / ragged-on-disk split the engine uses
    everywhere."""
    raw_file = os.path.join(workdir, "sipm_raw.lh5")
    wf, truth = make_sipm_waveforms(n)
    lh5.write(raw_table(wf), "spm01/raw", raw_file)

    dsp_file = os.path.join(workdir, "sipm_dsp.lh5")
    dspeed.build_dsp(raw_file, dsp_file, CONFIG, write_mode="r", device=device)
    print(f"[2] production on {device} complete -> {dsp_file}")
    return dsp_file, truth


# ---------------------------------------------------------------- step 3
def check_pulses(dsp, truth):
    """The found pulses against the injected truth: trigger efficiency
    over 85%, every energy positive. ``dsp`` is the DSP table (read from a
    file or returned in memory). Returns the pulses found per event."""
    trig = dsp["trigger_pos"]
    ene = dsp["energies"]
    # a VectorOfVectors holds a flat data array plus cumulative lengths;
    # event i's pulse list is flat[cl[i - 1]:cl[i]]
    cl = np.asarray(trig.cumulative_length.nda).astype(np.int64)
    flat_t = np.asarray(trig.flattened_data.nda)[: cl[-1] if len(cl) else 0]
    n_found = np.diff(cl, prepend=0)
    print(f"    events: {len(n_found)}; pulses found: {n_found.sum()} "
          f"(mean {n_found.mean():.2f}/event)")

    # validate against the injected truth: pulse times are in ns (dt = 16
    # ns), and the current-derivative trigger fires on the rise
    matched = total_true = 0
    for i, t0s in enumerate(truth):
        found_samples = flat_t[cl[i] - n_found[i]:cl[i]] / DT
        for t0 in t0s:
            total_true += 1
            if len(found_samples) and np.min(np.abs(found_samples - t0)) < 12:
                matched += 1
    eff = matched / max(total_true, 1)
    print(f"    trigger efficiency vs injected truth: {eff:.1%}")
    assert eff > 0.85, f"pulse-finding efficiency collapsed: {eff:.1%}"

    # energies: every found pulse gets a positive current amplitude
    ecl = np.asarray(ene.cumulative_length.nda).astype(np.int64)
    np.testing.assert_array_equal(ecl, cl)
    flat_e = np.asarray(ene.flattened_data.nda)[: ecl[-1] if len(ecl) else 0]
    assert (flat_e > 0).all()
    if len(flat_e):
        print(f"    energies: {flat_e.min():.1f}..{flat_e.max():.1f} ADC")
    return n_found


def step3_read_vov(dsp_file, truth):
    """Read the ragged columns back and check them against the truth."""
    dsp = lh5.read("spm01/dsp", dsp_file)
    print("[3] read back the VoV columns:")
    return check_pulses(dsp, truth)


# ---------------------------------------------------------------- step 4
def checked_in_memory(tb, device="cuda"):
    """Checked mode on an in-memory table of clean events: production runs
    unchanged, every column equal to the unchecked run's. Returns the
    checked run's table."""
    out = produce(tb, device, checked=True)
    want = produce(tb, device)
    for k in ("trigger_pos", "energies"):
        for q in ("cumulative_length", "flattened_data"):
            a = np.asarray(getattr(out[k], q).nda)
            b = np.asarray(getattr(want[k], q).nda)
            assert a.tobytes() == b.tobytes(), (k, q)
    return out


def step4_checked_mode(workdir, device="cuda"):
    """Checked mode works for SiPM chains too: the per-event data checks
    (pick-off indices, search starts) halt production with the exact entry
    instead of silently NaN-ing the event."""
    raw_file = os.path.join(workdir, "sipm_raw.lh5")
    out = os.path.join(workdir, "sipm_checked_dsp.lh5")
    dspeed.build_dsp(raw_file, out, CONFIG, write_mode="r", checked=True, device=device)
    print("[4] checked-mode production: clean data passes unchanged")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as workdir:
        dsp_file, truth = step2_production(workdir, args.device)
        step3_read_vov(dsp_file, truth)
        step4_checked_mode(workdir, args.device)
        print("tutorial 2 complete")


if __name__ == "__main__":
    main()
