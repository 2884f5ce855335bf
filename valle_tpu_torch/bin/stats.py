"""Manifest statistics: the twin of ``valle_tpu/bin/stats.py``.  Prints
``Manifest.describe()`` (count, total duration, duration percentiles) for
each ``manifest_*.jsonl.gz`` of a directory.

Run: python -m valle_tpu_torch.bin.stats --manifest-dir data/tokenized
"""

from __future__ import annotations

import argparse
from pathlib import Path

from valle_tpu_torch.data import Manifest


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--manifest-dir", type=Path, required=True)
    args = p.parse_args(argv)
    for manifest in sorted(args.manifest_dir.glob("manifest_*.jsonl.gz")):
        print(f"== {manifest.name} ==")
        print(Manifest.load(manifest).describe())
        print()


if __name__ == "__main__":
    main()
