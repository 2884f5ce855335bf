"""Guards of the port: it imports no JAX and nothing of ``valle_tpu``, its
entry points refuse to run without CUDA unless asked for the CPU, its kernel
modules import without ``nvcc``, and ``chip_smoke.py`` fails fast here."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import valle_tpu_torch
for mod in pkgutil.walk_packages(valle_tpu_torch.__path__, "valle_tpu_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "valle_tpu") or m.startswith(("jax.", "flax.", "valle_tpu.")))
print(",".join(bad))
"""


def _run(code_or_args, cwd=ROOT, timeout=120):
    args = [sys.executable, "-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run(args, cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax_and_no_valle_tpu():
    """Every module of the port, found by walking the package (codec, data
    and bin included, and whatever later slices add)."""
    res = _run(_IMPORT_ALL)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"port pulled in: {res.stdout.strip()}"
    found = _run("import pkgutil, valle_tpu_torch; print(' '.join(m.name for m in "
                 "pkgutil.walk_packages(valle_tpu_torch.__path__, 'valle_tpu_torch.')))")
    names = set(found.stdout.split())
    assert {"valle_tpu_torch.codec.encodec_model", "valle_tpu_torch.data.text_tokenizer",
            "valle_tpu_torch.bin.infer", "valle_tpu_torch.sample", "valle_tpu_torch.bin.serve",
            "valle_tpu_torch.sample.continuous", "valle_tpu_torch.nn.qdense",
            "valle_tpu_torch.parallel.dist", "valle_tpu_torch.parallel.mesh"} <= names, \
        sorted(names)


def test_chip_smoke_imports_nothing_of_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            mod = stripped.split()[1]
            assert mod.split(".")[0] not in ("jax", "flax"), line
            assert mod != "valle_tpu" and not mod.startswith("valle_tpu."), line


def test_chip_smoke_fails_fast_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    res = _run([sys.executable, "chip_smoke.py"], timeout=60)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path, timeout=60)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_entry_points_raise_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.utils.bridge import state_dict_from_jax

    cfg = ModelConfig(decoder_dim=32, nhead=2, num_layers=1, num_quantizers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        state_dict_from_jax({}, cfg)
    assert next(get_model(cfg, device="cpu").parameters()).device.type == "cpu"
    tts = cfg.replace(model_name="Transformer")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(tts)
    assert next(get_model(tts, device="cpu").parameters()).device.type == "cpu"


def test_codec_and_infer_cli_raise_without_cuda_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    from valle_tpu_torch.bin import infer
    from valle_tpu_torch.codec import EncodecConfig, load_codec, random_codec_params
    from valle_tpu_torch.codec import save_codec_npz

    small = EncodecConfig(num_filters=4, hidden_size=16, codebook_dim=16)
    save_codec_npz(tmp_path / "codec.npz", random_codec_params(small))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_codec(tmp_path / "codec.npz")
    assert load_codec(tmp_path / "codec.npz", device="cpu").device.type == "cpu"
    argv = ["--checkpoint", str(tmp_path / "model.npz"), "--output-dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(argv + ["--device", "cuda"])
    assert not (tmp_path / "out").exists()  # it raised before it wrote anything


def test_serve_cli_raises_without_cuda_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    from valle_tpu_torch.bin import serve

    argv = ["--requests", str(tmp_path / "reqs.tsv"), "--checkpoint", str(tmp_path / "m.npz"),
            "--text-tokens", str(tmp_path / "t.k2symbols"), "--output-dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(argv)
    assert not (tmp_path / "out").exists()
    assert serve.get_parser().parse_args(argv).device == "cuda"
    with pytest.raises(FileNotFoundError):  # past the device check, at the checkpoint
        serve.main(argv + ["--device", "cpu"])


def test_kernel_wrappers_use_plain_versions_on_cpu():
    from valle_tpu_torch.ops.fused_attention import (
        fused_prefix_attention, fused_prefix_attention_backward)
    from valle_tpu_torch.ops.ragged_decode import ragged_decode_attention

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 2, 16, generator=g)
    k = torch.randn(2, 5, 2, 16, generator=g)
    before = (fused_prefix_attention.launches, ragged_decode_attention.launches)
    fused_prefix_attention(q, k, k, None, prefix_s=2)
    ragged_decode_attention(q[:, :1], k, k, torch.tensor([5, 0], dtype=torch.int32))
    assert (fused_prefix_attention.launches, ragged_decode_attention.launches) == before
    q.requires_grad_()
    back = fused_prefix_attention_backward.launches
    out = fused_prefix_attention(q, k, k, None, prefix_s=2, dropout_rate=0.1, dropout_seed=1)
    out.sum().backward()
    assert fused_prefix_attention.launches == before[0]
    assert fused_prefix_attention_backward.launches == back


def test_kernel_4_wrapper_uses_plain_versions_on_cpu():
    from valle_tpu_torch.ops.flash_attention import (
        flash_attention_biased, flash_attention_biased_backward)

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 2, 16, generator=g, requires_grad=True)
    bias = torch.randn(2, 1, 5, 5, generator=g, requires_grad=True)
    before = (flash_attention_biased.launches, flash_attention_biased_backward.launches)
    flash_attention_biased(q, q, q, bias).sum().backward()
    assert q.grad is not None and bias.grad.shape == bias.shape
    assert (flash_attention_biased.launches, flash_attention_biased_backward.launches) == before


def test_cuda_build_needs_no_nvcc_at_import():
    from valle_tpu_torch.ops import cuda_build

    assert (cuda_build.CSRC / "ragged_decode.cu").exists()
    assert (cuda_build.CSRC / "prefix_attention.cu").exists()
    assert (cuda_build.CSRC / "prefix_attention_bwd.cu").exists()
    assert (cuda_build.CSRC / "attention_common.cuh").exists()
    assert (cuda_build.CSRC / "mma_tile.cuh").exists()
    assert (cuda_build.CSRC / "philox.cuh").exists()
    assert cuda_build.BUILD_DIR.parts[-2:] == ("build", "valle_tpu_torch")
    # the compiler's log is keyed like the library, so it always belongs to it
    lib, log = cuda_build._lib_path("prefix_attention_bwd"), cuda_build.log_path(
        "prefix_attention_bwd")
    assert log.parent == lib.parent and log.stem == lib.stem and log.suffix == ".log"


def test_package_scan_covers_the_training_modules():
    """The import scan above walks the training CLI, its data pipeline and
    the checkpoint, metrics, debug, optimizer and FLOPs modules too."""
    found = _run("import pkgutil, valle_tpu_torch; print(' '.join(m.name for m in "
                 "pkgutil.walk_packages(valle_tpu_torch.__path__, 'valle_tpu_torch.')))")
    names = set(found.stdout.split())
    assert {f"valle_tpu_torch.{m}" for m in (
        "bin.train", "data.vshard", "data.shards", "data.native_loader", "data.bucketing",
        "data.input_strategies", "data.transforms", "data.dataset", "optim.eve", "optim.adam",
        "train.metrics", "train.checkpoint", "train.debug", "utils.flops")} <= names, \
        sorted(names)
