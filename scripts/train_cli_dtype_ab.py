#!/usr/bin/env python3
"""The port's training CLI in f32, in bf16, and in bf16 with ``--remat
dots_nobatch`` on one tokenized corpus, on one CUDA card.

    python3 scripts/train_cli_dtype_ab.py

It writes the serving files and tokenizes the corpus of ``chip_smoke.py``'s
``tokenize_cli`` phase (64 + 8 seeded wavs of 4-6 s through the full-width
random EnCodec), then runs the full-width VALL-E through stage 1 (1 epoch)
and stage 2 (1 more epoch) with that phase's flags (``BF16_CLI_FLAGS``
without the dtype and remat flags, no OOM scan) once per setting, each in
its own exp dir from the same seed.  The step generators are the same in
every run, so the per-step losses compare step by step.  Prints the card's
name and power limit, then one JSON line per setting: the per-step loss
over frames of each stage and the seconds of every step.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SETTINGS = (("float32", []), ("bfloat16", []), ("bfloat16 dots_nobatch",
                                                 ["--remat", "dots_nobatch"]))


def main() -> int:
    import torch

    import chip_smoke as cs
    from valle_tpu_torch.bin import train as train_cli
    from valle_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("train_cli_dtype_ab: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    cuda_build.build(cs.KERNELS)
    flags = list(cs.BF16_CLI_FLAGS)
    for name in ("--dtype", "--remat"):
        i = flags.index(name)
        del flags[i: i + 2]
    with tempfile.TemporaryDirectory() as tmp:
        files = cs.write_serving_files(Path(tmp))
        _, codes_dir, _ = cs.tokenize_cli_path(torch.device("cuda"), files,
                                               files["dir"] / "data_cli")
        for name, extra in SETTINGS:
            argv = ["--manifest-dir", str(codes_dir), "--exp-dir",
                    str(files["dir"] / name.replace(" ", "_")), *flags, "--dtype",
                    name.split()[0], *extra, "--oom-check", "false"]
            stages = [train_cli.main(argv + ["--train-stage", "1", "--num-epochs", "1"]),
                      train_cli.main(argv + ["--train-stage", "2", "--num-epochs", "2"])]
            print(json.dumps({
                "setting": name,
                **{f"stage{i + 1}_loss_per_frame": [s["loss"] / s["frames"] for s in st["steps"]]
                   for i, st in enumerate(stages)},
                "step_s": [s["step_s"] for st in stages for s in st["steps"]]}), flush=True)
            del stages
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
