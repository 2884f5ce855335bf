"""Rank processes over gloo for the port's multi-process tests, and the jobs
they run.  Nothing here imports JAX: a rank runs the port only.

``run_ranks(job, world, *args)`` starts ``world`` Python processes, each
calling ``job`` (a function of this module) as one rank of a gloo group on
the CPU with a 120 s collective timeout and one torch thread, and returns
their standard outputs.  Each process has a deadline; when one fails, or the
deadline passes, every process still running is killed and the test fails
with their output, so a hang fails one test instead of the whole run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from valle_tpu_torch.parallel import dist

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120


def run_processes(argvs, timeout: float = 300, env=None) -> list:
    """Run each argv as a process from the repo root, one torch thread each;
    returns their standard outputs.  Fails with the outputs when one fails,
    and kills the rest."""
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    logs = Path(tempfile.mkdtemp(prefix="ranks-"))
    procs, files = [], []
    for i, argv in enumerate(argvs):
        out = open(logs / f"{i}.out", "w+")
        files.append(out)
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in files:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for i, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"process {i} of {len(procs)} ended with {p.returncode}:\n" + \
            "\n".join(f"--- process {j}\n{t[-3000:]}" for j, t in enumerate(texts))
    return texts


def run_ranks(job: str, world: int, *args, timeout: float = 300) -> list:
    """``job(*args)`` as each rank of a ``world``-rank gloo group."""
    address = f"127.0.0.1:{dist.free_port()}"
    code = "from tests.torch_ranks import _rank_main; _rank_main()"
    return run_processes([[sys.executable, "-c", code, job, str(r), str(world), address,
                           *map(str, args)] for r in range(world)], timeout)


def _rank_main() -> None:
    from valle_tpu_torch.parallel import dist

    job, rank, world, address, *args = sys.argv[1:]
    torch.set_num_threads(1)
    dist.initialize(address, int(world), int(rank), device="cpu", force=True,
                    timeout_s=RANK_TIMEOUT_S)
    try:
        globals()[job](*args)
    finally:
        dist.shutdown()


# ------------------------------------------------------------- training jobs

A, B, S, T, Q = 2, 8, 16, 24, 8
TRAIN_KW = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=Q, dropout=0.0,
                attn_impl="fused")
TTS_KW = dict(model_name="Transformer", decoder_dim=64, nhead=4, num_layers=2, dropout=0.0,
              attn_impl="flash")
# (model, train stage, prefix mode) per case; the parity cases first
TRAIN_CASES = {"valle_stage1": ("valle", 1, 0), "valle_stage2": ("valle", 2, 0),
               "tts": ("tts", 0, 0), "valle_stage2_mode1": ("valle", 2, 1),
               "valle_stage2_mode2": ("valle", 2, 2)}
PARITY_CASES = list(TRAIN_CASES)[:4]
# the cases whose ranks hold batches of other widths (``narrow`` batches)
WIDTH_CASES = ["valle_stage1", "valle_stage2_mode1", "tts"]


def train_batch(case: str, rows=None, b: int = B, seed: int = 0, narrow: bool = False) -> dict:
    """An (A, b, ...) batch of random tokens (mels for the TTS baseline)
    with ragged lengths; ``rows`` picks rows of it.  ``narrow``: the rows
    of the second half are shorter (text at most S - 4, audio at most T - 5),
    and a batch of those rows alone is cut to its longest lengths, as a
    bucketing loader's batch of shorter utterances is."""
    rng = np.random.RandomState(seed)
    x_lens = rng.randint(S // 2, S + 1, (A, b))
    y_lens = rng.randint(T // 2, T + 1, (A, b))
    if narrow:
        x_lens[:, b // 2:] = np.minimum(x_lens[:, b // 2:], S - 4)
        y_lens[:, b // 2:] = np.minimum(y_lens[:, b // 2:], T - 5)
    x_lens[:, 0], y_lens[:, 0] = S, T
    if TRAIN_CASES[case][0] == "tts":
        y = rng.randn(A, b, T, 100).astype(np.float32)
    else:
        y = rng.randint(0, 1024, (A, b, T, Q))
    batch = {"text_tokens": rng.randint(1, 512, (A, b, S)), "text_tokens_lens": x_lens,
             "audio_features": y, "audio_features_lens": y_lens}
    if rows is not None:
        batch = {k: v[:, rows] for k, v in batch.items()}
        if narrow:
            s, t = batch["text_tokens_lens"].max(), batch["audio_features_lens"].max()
            batch["text_tokens"] = batch["text_tokens"][:, :, :s]
            batch["audio_features"] = batch["audio_features"][:, :, :t]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def train_setup(case: str, weights: str):
    """(state, step) of ``case`` from the state dict at ``weights`` (VALL-E)
    or the seeded init (the TTS baseline), ScaledAdam + Eden at dropout 0."""
    import functools

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.optim import ScaledAdam, eden_lr
    from valle_tpu_torch.train.step import init_train_state

    kind, stage, mode = TRAIN_CASES[case]
    torch.manual_seed(0)
    cfg = ModelConfig(**TTS_KW) if kind == "tts" else ModelConfig(prefix_mode=mode, **TRAIN_KW)
    model = get_model(cfg, device="cpu", training=True)
    if kind != "tts":
        model.load_state_dict(torch.load(weights))
    make_opt = functools.partial(ScaledAdam, lr=0.02, clipping_scale=2.0, betas=(0.9, 0.95))
    return init_train_state(model, make_opt, train_stage=stage), stage


def train_step_result(case: str, weights: str, batch: dict, mesh=None, gen_seed: int = 1) -> dict:
    """One deterministic step: the loss, the gradients the optimizer got,
    the updated weights' checksum and the step generator's state."""
    from valle_tpu_torch.optim import eden_lr
    from valle_tpu_torch.train.step import make_train_step

    state, stage = train_setup(case, weights)
    grads = {}
    opt_step = state.optimizer.step
    names = {id(p): n for n, p in state.model.named_parameters()}

    def capture(*a, **kw):
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                grads[names[id(p)]] = p.grad.clone()
        return opt_step(*a, **kw)

    state.optimizer.step = capture
    step = make_train_step(lambda s, e: eden_lr(0.05, s, e), train_stage=stage,
                           deterministic=True, mesh=mesh)
    gen = torch.Generator().manual_seed(gen_seed)
    state, metrics = step(state, batch, gen, 0)
    return {"loss": float(metrics["loss"]), "frames": float(metrics["frames"]), "grads": grads,
            "checksum": sum(float(p.detach().abs().sum()) for p in state.model.parameters()),
            "weights": {k: v.clone() for k, v in state.model.state_dict().items()},
            "gen_state": gen.get_state()}


def train_job(out_dir: str, weights: str) -> None:
    """Every case on this rank's half of the batch, the width cases on the
    half of a narrow batch, then stage 2 in prefix modes 2 and 1 with a
    batch size of the rank's own (and in mode 1 a generator of its own),
    recording the NAR stages and the shared draws."""
    from valle_tpu_torch.parallel.mesh import Mesh
    from valle_tpu_torch.models.valle import VALLE

    mesh = Mesh()
    rank, world = dist.process_index(), dist.process_count()
    half = slice(rank * B // world, (rank + 1) * B // world)
    for case in PARITY_CASES:
        res = train_step_result(case, weights, train_batch(case, half), mesh)
        torch.save(res, Path(out_dir) / f"{case}_rank{rank}.pt")
    for case in WIDTH_CASES:
        res = train_step_result(case, weights, train_batch(case, half, narrow=True), mesh)
        torch.save(res, Path(out_dir) / f"{case}_narrow_rank{rank}.pt")

    stages, draws = [], []
    forward_nar, broadcast_int = VALLE._forward_nar, dist.broadcast_int

    def record(self, *args, **kw):
        stages.append(int(args[6]))
        return forward_nar(self, *args, **kw)

    def shared(value, group=None):
        out = broadcast_int(value, group)
        draws.append([value, out])
        return out

    VALLE._forward_nar, dist.broadcast_int = record, shared
    for case, gen_seed in (("valle_stage2_mode2", 1), ("valle_stage2_mode1", 1 + rank)):
        train_step_result(case, weights, train_batch(case, b=3 + 2 * rank, seed=rank), mesh,
                          gen_seed)
    (Path(out_dir) / f"stages_rank{rank}.json").write_text(
        json.dumps({"stages": stages, "draws": draws}))


# ----------------------------------------------------------- generation jobs

GEN_B, GEN_S, GEN_P, MAX_NEW = 8, 6, 8, 16
GEN_KW = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=Q, kv_cache_dtype="int8",
              attn_impl="flash")


def gen_inputs() -> dict:
    rng = np.random.RandomState(0)
    arrays = {"x": rng.randint(1, 512, (GEN_B, GEN_S)),
              "x_lens": rng.randint(4, GEN_S + 1, (GEN_B,)),
              "prompt_codes": rng.randint(0, 1024, (GEN_B, GEN_P, Q)),
              "prompt_lens": rng.randint(3, GEN_P + 1, (GEN_B,))}
    return {k: torch.from_numpy(v).long() for k, v in arrays.items()}


def gen_model(weights: str, w8a8: bool):
    from valle_tpu_torch.models import ModelConfig, get_model

    cfg = ModelConfig(act_quant=w8a8, **GEN_KW)
    return get_model(cfg, device="cpu", state_dict=torch.load(weights), quantize=w8a8)


def gen_result(model, rows: dict, ragged: bool) -> dict:
    """The prefill's last logits and greedy codes of ``rows``."""
    from valle_tpu_torch.sample import _prefill_kv, generate

    with torch.inference_mode():
        logits = _prefill_kv(model, rows["x"], rows["x_lens"], rows["prompt_codes"],
                             rows["prompt_lens"])[0]
    out = generate(model, **rows, top_k=1, max_new_tokens=MAX_NEW, forbid_eos=True,
                   ragged_decode=ragged, generator=torch.Generator().manual_seed(3))
    return {"logits": logits, **out}


def generate_job(out_dir: str, weights: str, data: str, model: str, w8a8: str) -> None:
    """Greedy generation on a data x model mesh of ranks: this rank's rows on
    its heads; the first rank saves the gathered prefill logits and codes."""
    from valle_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_batch, shard_parameters_

    mesh = Mesh(int(data), int(model))
    net = shard_parameters_(gen_model(weights, w8a8 == "1"), mesh)
    res = gen_result(net, shard_batch(gen_inputs(), mesh), ragged=True)
    res = {k: gather_rows(v, mesh) for k, v in res.items()}
    if mesh.is_primary:
        torch.save(res, Path(out_dir) / f"generate_{data}x{model}.pt")