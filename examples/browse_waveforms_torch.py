"""dspeed-tpu worked example on the PyTorch / CUDA port: browse raw and
DSP-transformed waveforms.

The port's counterpart of ``examples/browse_waveforms.py``: a synthetic HPGe
raw file (``quickstart_torch``'s generator), the two browsers of that example over the flagship energy+timing
config on ``dspeed_tpu_torch.vis.WaveformBrowser`` (its chain on an NVIDIA
card by default; the CPU when asked), a few annotated events rendered to PNG
(headless matplotlib, no display needed). It imports neither JAX nor the JAX
package. Run it from the repository's root:

    PYTHONPATH=. python examples/browse_waveforms_torch.py                # the card
    PYTHONPATH=. python examples/browse_waveforms_torch.py --device cpu   # anywhere

Writing the raw file needs ``h5py`` and drawing needs ``matplotlib``. The
browsers also take an in-memory table, and finding entries (each stored
line's ``get_xdata()`` / ``get_ydata()``) needs neither: ``curves_browser``
and ``aligned_browser`` build them on a file or a table. Without a card and
without ``device="cpu"`` they raise; they never fall back to the CPU.
"""

import argparse
import os
import tempfile

from dspeed_tpu_torch import lh5
from dspeed_tpu_torch.vis import WaveformBrowser
from quickstart_torch import CONFIG, DB, make_waveforms, raw_table

GROUP = "ch001/raw"


def curves_browser(raw, device="cuda"):
    """The first browser: baseline-subtracted waveform + energy trapezoid
    as curves, trapEmax as a horizontal line, tp_50 as a vertical line,
    per-event values formatted into the legend, times in microseconds.
    ``raw`` is a raw file (its table ``GROUP``) or an in-memory table."""
    return WaveformBrowser(
        raw,
        GROUP,
        dsp_config=CONFIG,
        database=DB,
        lines=["wf_blsub", "wf_trap", "trapEmax", "tp_50"],
        styles=[
            {"color": ["tab:blue"], "ls": ["-"]},
            {"color": ["tab:orange"], "ls": ["--"]},
            {"color": ["tab:red"], "ls": [":"]},
            {"color": ["tab:green"], "ls": [":"]},
        ],
        # bare names expand to "name = {name}"; full format strings may
        # reference any chain variable
        legend=["bl_mean", "trapTmax", "E = {trapEmax:.0f} ADC",
                "tp50 = {tp_50:.0f}"],  # unit appended automatically
        x_unit="us",
        n_drawn=1,
        device=device,
    )


def aligned_browser(raw, device="cuda"):
    """The second browser: three events in one panel, each normalised by
    its trapEmax and aligned on its 50% crossing."""
    return WaveformBrowser(
        raw,
        GROUP,
        dsp_config=CONFIG,
        database=DB,
        lines=["wf_pz"],
        norm="trapEmax",          # unit height
        align="tp_50",            # line up the 50% crossing
        x_unit="us",
        n_drawn=3,
        device=device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    workdir = tempfile.mkdtemp(prefix="dspeed_tpu_torch_browse_")
    raw_file = os.path.join(workdir, "demo_raw.lh5")
    wf, amp, bl = make_waveforms(n=64)
    lh5.write(raw_table(wf, bl), GROUP, raw_file)

    # each browser draws on a figure of its own, saved through it
    browser = curves_browser(raw_file, args.device)
    for entry in (3, 17):
        browser.set_figure(plt.figure(figsize=(8, 4.5)), plt.gca())
        browser.draw_entry(entry)
        png = os.path.join(workdir, f"event_{entry:04d}.png")
        browser.save_figure(png, dpi=110)
        plt.close(browser.fig)
        print("wrote", png)

    # overlay three aligned, normalized events in one panel
    browser2 = aligned_browser(raw_file, args.device)
    browser2.set_figure(plt.figure(figsize=(8, 4.5)), plt.gca())
    browser2.draw_next()
    png = os.path.join(workdir, "aligned_overlay.png")
    browser2.save_figure(png, dpi=110)
    plt.close(browser2.fig)
    print("wrote", png)
    return workdir


if __name__ == "__main__":
    main()
