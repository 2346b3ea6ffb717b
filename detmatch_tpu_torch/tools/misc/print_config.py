"""Print a fully resolved config (counterpart of
``tools/misc/print_config.py``).

Usage:
    python -m detmatch_tpu_torch.tools.misc.print_config CONFIG
        [--cfg-options k=v ...]
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--cfg-options", nargs="*", default=None)
    args = ap.parse_args(argv)
    from ..train import load_config
    text = load_config(args.config, args.cfg_options).dump()
    print(text)
    return text


if __name__ == "__main__":
    main()
