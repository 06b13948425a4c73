"""Command line interface: the ``dspeed-tpu-torch`` executable.

The port of ``dspeed_tpu/cli.py``, which mirrors the reference CLI surface
(``dspeed/cli.py:13-190``): multiple input files, multiple ``--config``
files merged in order (a recursive dict merge), wildcard HDF5 groups, the
write-mode group ``--overwrite``/``--update``/``--append``, and
``<base>_dsp.lh5`` output naming. It adds ``--device`` and ``--fuse``,
which the JAX package takes from its environment.

    python -m dspeed_tpu_torch.cli run42_raw.lh5 -c config.yaml -D db.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from . import __version__, build_dsp
from . import logging as dsp_logging
from .config import DEFAULT_DEVICE

__all__ = ["dspeed_cli", "main"]

_FUSE = {"true": True, "false": False, "generic": "generic"}


def _read_config(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        import yaml

        return yaml.safe_load(text)


def _merge(dst: dict, src: dict) -> dict:
    """Recursive in-place dict merge, later sources win (Props.read_from)."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def dspeed_cli(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="dspeed-tpu-torch",
        description="Process LH5 raw files into dsp files using a JSON/YAML "
        "DSP configuration, on a CUDA device (PyTorch).",
    )
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument("--verbose", "-v", action="store_true",
                        help="increase the program verbosity")
    parser.add_argument("--debug", "-d", action="store_true",
                        help="increase the program verbosity to maximum")
    parser.add_argument("raw_lh5_file", nargs="+",
                        help="input raw LH5 file(s)")
    parser.add_argument("--config", "-c", nargs="*", required=True,
                        help="JSON/YAML DSP configuration file(s), merged in order")
    parser.add_argument("--hdf5-groups", "-g", nargs="*", default=None,
                        help="LH5 group(s) to process; wildcards supported")
    parser.add_argument("--output", "-o", default=None,
                        help="output file name (single input only); default "
                        "<input>_dsp.lh5")
    parser.add_argument("--database", "-D", default=None,
                        help="JSON/YAML parameter database file")
    parser.add_argument("--output-pars", "-p", nargs="*", default=None,
                        help="additional output DSP parameters to write")
    parser.add_argument("--max-rows", "-n", default=None, type=int,
                        help="number of rows to process (default: all)")
    parser.add_argument("--block", "-b", default=16, type=int,
                        help="waveforms to process simultaneously (API parity; "
                        "the port batches whole chunks)")
    parser.add_argument("--chunk", "-k", default=3200,
                        type=lambda s: s if s == "auto" else int(s),
                        help="waveforms per disk read / device pass; 'auto' "
                        "probes the host -> device path and picks the fastest "
                        "chunk size")
    parser.add_argument("--checked", action="store_true",
                        help="halt with DSPFatal + entry range on "
                             "data-dependent kernel errors (reference "
                             "semantics) instead of NaN outputs")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help=f"torch device to run on (default: {DEFAULT_DEVICE})")
    parser.add_argument("--fuse", choices=sorted(_FUSE), default="true",
                        help="fusion pass: the hand patterns then the generic "
                        "pass (true, the default), the generic pass only "
                        "(generic), or none (false)")

    group = parser.add_mutually_exclusive_group()
    group.add_argument("--overwrite", "-w", action="store_const", const="r",
                       dest="writemode", default="r",
                       help="overwrite existing output file (default)")
    group.add_argument("--update", "-u", action="store_const", const="u",
                       dest="writemode",
                       help="update values in existing file")
    group.add_argument("--append", "-a", action="store_const", const="a",
                       dest="writemode",
                       help="append values to existing file")

    args = parser.parse_args(argv)

    if args.verbose:
        dsp_logging.setup(logging.DEBUG)
    elif args.debug:
        dsp_logging.setup(logging.DEBUG, logging.root)
    else:
        dsp_logging.setup()

    if len(args.raw_lh5_file) > 1 and args.output is not None:
        raise NotImplementedError(
            "not possible to set multiple output file names yet"
        )

    def derive_out(raw_path: str) -> str:
        stem = os.path.splitext(os.path.basename(raw_path))[0]
        return stem.removesuffix("_raw") + "_dsp.lh5"

    if len(args.raw_lh5_file) == 1 and args.output is not None:
        out_files = [args.output]
    else:
        out_files = [derive_out(f) for f in args.raw_lh5_file]

    config: dict = {}
    for cfg in args.config:
        _merge(config, _read_config(cfg))

    for raw_file, out_file in zip(args.raw_lh5_file, out_files):
        build_dsp(
            raw_file,
            out_file,
            config,
            lh5_tables=args.hdf5_groups,
            database=args.database,
            outputs=args.output_pars,
            n_entries=args.max_rows,
            write_mode=args.writemode,
            buffer_len=args.chunk,
            block_width=args.block,
            device=args.device,
            fuse=_FUSE[args.fuse],
            checked=args.checked,
        )


main = dspeed_cli

if __name__ == "__main__":
    dspeed_cli()
