"""Training CLI: the twin of ``valle_tpu/bin/train.py``, on the card unless
``--device cpu`` is given.

Two-stage AR / NAR recipes, ScaledAdam / Eve / AdamW / Adam with Eden / Noam
/ Cosine, bucketed loading by ``--max-duration``, gradient accumulation,
periodic and best checkpoints with keep-last-k (``train/checkpoint.py``,
``.pt`` files), mid-epoch resume with the loader's state, validation every
``--valid-interval``, model averaging, ``--inf-check``, and a pre-flight
scan of every batch shape of the epoch.  It takes every flag of the JAX
parser with the same defaults, plus ``--device``.

What differs from the JAX CLI, and why:
  - the OOM scan runs one forward and backward per distinct (S, T, B) of
    the epoch with its own generator and no optimizer step (eager PyTorch
    has nothing to compile ahead), as the reference's
    ``scan_pessimistic_batches_for_oom`` does; it leaves the weights, the
    buffers and the training generator as they were;
  - step n draws its dropout and stage from a CPU generator derived from
    ``(seed + 1, n)`` (JAX folds n into one key), so a run resumed from a
    checkpoint repeats the uninterrupted run's steps bit for bit;
  - the loader's saved state counts the groups the loop has trained on, not
    the ones the prefetch thread has built ahead, and holds SpecAugment's
    generator as it was after them (the JAX CLI saves no such state, so its
    resumed run draws other masks); epoch checkpoints keep it too;
  - resume takes the checkpoint with the most steps (an epoch one at a tie),
    and from ``epoch-N`` it starts epoch N + 1, as the reference's
    ``--start-epoch N+1`` does (the JAX CLI prefers any step checkpoint and
    trains epoch N again); so stage 2 of the two-stage recipe starts from
    stage 1's final weights at the next epoch;
  - ``--inf-check`` reads the loss before the update, so its report names
    the parameters and the module as they were when the loss went bad;
  - ``--rng-impl`` names a JAX PRNG and has no effect here;
  - data parallelism runs one process per card, where JAX runs one per
    host, and ``--dist-backend`` (nccl on the card, gloo on the CPU) picks
    the collectives.

Data parallelism (``--num-processes N --process-id r --coordinator-address
host:port``, one command per card): rank r trains on ``cuda:{r %
device_count}`` over its share of the loader's groups (the loader is
rank-sharded and every rank takes as many steps), and the step sums the
gradients and metrics over the ranks (``train/step.py``), so a step is the
global batch's, as JAX's step over its global batch.  The weights are
broadcast from rank 0 before the optimizer is built; rank 0 writes the
checkpoints (every rank waits, then may resume from them), ``log.txt``,
TensorBoard, ``model.txt`` and the visualizer's PNGs; every rank validates
on the whole dev set, which is not rank-sharded (as each JAX host feeds its
own copy), so the validation loss is the single-process one.  The OOM scan
runs per rank on its own shapes, and MFU is per card.  ``--num-processes 1``
with a ``--coordinator-address`` makes a group of one, which runs every
collective and trains bit for bit as a run without it.

``--visualize true`` draws PNGs of the first validation batch at each
validation, as the JAX CLI does (``models/visualizer.py``, through
``VALLE.visualize_forward`` on the raw weights; skipped for the Transformer
baseline), into ``<exp-dir>/eval/step-<n>`` or ``eval/epoch-<n>``; it needs
matplotlib.

``--dtype bfloat16`` trains in mixed precision as the JAX CLI does: f32
parameters, gradients, optimizer state, averaged model and checkpoints,
bf16 compute (``models.get_model(cfg, training=True)``); the OOM scan and
validation run in the same dtype, and MFU is logged against the card's
bf16 peak.  ``--remat full | dots_nobatch`` recomputes each layer of the
stacks in the backward pass (``nn/layers.py``).

Run: python -m valle_tpu_torch.bin.train --manifest-dir data/ --exp-dir exp/ ...
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from valle_tpu_torch.data import Manifest, Prefetcher, TtsDataLoader, get_text_token_collater
from valle_tpu_torch.models import add_model_arguments, config_from_args, get_model, str2bool
from valle_tpu_torch.optim import ConstantLrAdam, ConstantLrAdamW, Eve, ScaledAdam, get_lr_fn
from valle_tpu_torch.parallel import dist
from valle_tpu_torch.parallel.mesh import Mesh, replicate_
from valle_tpu_torch.train.checkpoint import CheckpointManager
from valle_tpu_torch.train.metrics import MetricsTracker
from valle_tpu_torch.train.state import partition_params
from valle_tpu_torch.train.step import (NonFiniteLoss, accumulate_gradients, init_train_state,
                                        make_eval_step, make_train_step)
from valle_tpu_torch.utils import resolve_device
from valle_tpu_torch.utils.flops import chip_peak_flops, train_step_flops


def get_parser():
    parser = argparse.ArgumentParser(description="Train VALL-E (PyTorch / CUDA)")
    add_model_arguments(parser)
    parser.add_argument("--manifest-dir", type=Path, required=True)
    parser.add_argument("--text-tokens", type=str, default="unique_text_tokens.k2symbols")
    parser.add_argument("--exp-dir", type=Path, required=True)
    parser.add_argument("--num-epochs", type=int, default=20)
    parser.add_argument("--start-epoch", type=int, default=1)
    parser.add_argument("--train-stage", type=int, default=0)
    parser.add_argument("--optimizer-name", type=str, default="ScaledAdam")
    parser.add_argument("--scheduler-name", type=str, default="Eden")
    parser.add_argument("--base-lr", type=float, default=0.05)
    parser.add_argument("--warmup-steps", type=int, default=200)
    parser.add_argument("--accumulate-grad-steps", type=int, default=1)
    parser.add_argument("--max-duration", type=float, default=40.0)
    parser.add_argument("--num-buckets", type=int, default=10)
    parser.add_argument("--filter-min-duration", type=float, default=0.0)
    parser.add_argument("--filter-max-duration", type=float, default=20.0)
    parser.add_argument("--batch-quant", type=int, default=8,
                        help="round batch example counts up to a multiple of this (masked "
                        "dummy rows); kept so that both packages see the same batches")
    parser.add_argument("--dataset", type=str, default="",
                        help="libritts/ljspeech: enables prefix-mode-4 prompts")
    parser.add_argument("--log-interval", type=int, default=100)
    parser.add_argument("--valid-interval", type=int, default=10000)
    parser.add_argument("--save-every-n", type=int, default=10000)
    parser.add_argument("--keep-last-k", type=int, default=20)
    parser.add_argument("--average-period", type=int, default=0)
    parser.add_argument("--init-checkpoint", type=str, default="",
                        help="warm-start the weights (optimizer and scheduler fresh) from a "
                        ".pt state dict or an .npz of flattened flax params; ignored when "
                        "the exp dir holds a checkpoint to resume from")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num-processes", type=int, default=1,
                        help="data-parallel training processes, one per card, each started "
                        "with its --process-id and the same --coordinator-address")
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--coordinator-address", type=str, default="",
                        help="host:port of rank 0's process group store; with "
                        "--num-processes 1 it makes a group of one")
    parser.add_argument("--dist-backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="collectives of the process group (default: nccl on cuda, gloo "
                        "on cpu; gloo on cuda stages through the host)")
    parser.add_argument("--inf-check", type=str2bool, default=False)
    parser.add_argument("--oom-check", type=str2bool, default=True)
    parser.add_argument("--tensorboard", type=str2bool, default=True)
    parser.add_argument("--visualize", type=str2bool, default=False,
                        help="dump eval PNGs of the first validation batch under "
                        "<exp-dir>/eval (needs matplotlib; not for the Transformer)")
    parser.add_argument("--enable-spec-aug", type=str2bool, default=False,
                        help="SpecAugment on log-mel features (Transformer baseline)")
    parser.add_argument("--spec-aug-time-warp-factor", type=int, default=80)
    parser.add_argument("--profile-steps", type=str, default="",
                        help="'START,END': a torch.profiler trace of those train steps "
                        "into <exp-dir>/profile")
    parser.add_argument("--rng-impl", type=str, default="rbg",
                        choices=["rbg", "threefry2x32", "unsafe_rbg"],
                        help="accepted for the JAX CLI's command lines; it names a JAX PRNG "
                        "and has no effect here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (raises without CUDA) | cpu")
    return parser


def make_optimizer(args):
    """(make(params) -> optimizer, grad-norm clip) as the JAX CLI builds
    them: ScaledAdam (clipping scale 2.0, betas 0.9 / 0.95) and Eve (betas
    0.9 / 0.98, target RMS 0.1) at the scheduler's rate; Adam and AdamW
    (betas 0.9 / 0.95, AdamW decay 1e-2) with the grad-norm clip 1.0 and a
    constant ``--base-lr``."""
    name, lr = args.optimizer_name, args.base_lr
    if name == "ScaledAdam":
        return functools.partial(ScaledAdam, lr=lr, clipping_scale=2.0, betas=(0.9, 0.95)), None
    if name == "Eve":
        return functools.partial(Eve, lr=lr, betas=(0.9, 0.98), target_rms=0.1), None
    if name == "AdamW":
        return functools.partial(ConstantLrAdamW, lr=lr, betas=(0.9, 0.95),
                                 weight_decay=1e-2), 1.0
    if name == "Adam":
        return functools.partial(ConstantLrAdam, lr=lr, betas=(0.9, 0.95)), 1.0
    raise NotImplementedError(name)


def step_generator(seed: int, step: int) -> torch.Generator:
    """Step ``step``'s CPU generator, a pure function of (seed + 1, step)."""
    hi, lo = np.random.SeedSequence([seed + 1, step]).generate_state(2)
    return torch.Generator().manual_seed((int(hi) << 32) | int(lo))


# page-locked staging buffers of to_device, per (device, name, shape, dtype),
# and per device the event of its last batch's copies
_STAGING: dict = {}
_LAST_COPY: dict = {}


def to_device(arrays: dict, dev: torch.device) -> dict:
    """Host numpy arrays -> tensors on ``dev``.  On the card each array goes
    through a page-locked buffer kept for its name, shape and dtype (the
    bucketing sampler gives few shapes), then a ``non_blocking`` copy; a
    buffer is written again only once the last batch's copies are done.
    Kept buffers spare the page-locked allocation that a fresh
    ``pin_memory()`` makes per batch."""
    if dev.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    if dev in _LAST_COPY:
        _LAST_COPY[dev].synchronize()
    out = {}
    for k, v in arrays.items():
        src = torch.from_numpy(np.ascontiguousarray(v))
        key = (dev, k, tuple(src.shape), src.dtype)
        buf = _STAGING.get(key)
        if buf is None:
            buf = _STAGING[key] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        out[k] = buf.to(dev, non_blocking=True)
    _LAST_COPY[dev] = torch.cuda.Event()
    _LAST_COPY[dev].record(torch.cuda.current_stream(dev))
    return out


def mfu_peak(dtype: str, dev: torch.device, device_name=None):
    """The card's peak FLOP/s for the MFU log, or None (logged as
    ``mfu=n/a``) on a host CPU and on a card that ``utils/flops.py`` does
    not know, which trains all the same."""
    if dev.type != "cuda":
        return None
    try:
        return chip_peak_flops(dtype, device_name)
    except ValueError as e:
        logging.warning(f"{e}; the log shows mfu=n/a")
        return None


def _variant(cfg) -> str:
    name = cfg.model_name.lower()
    return "transformer" if name == "transformer" else (
        "vallf" if name in ("vall-f", "vallf") else "valle")


def _peak_memory(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0.0


def run(args) -> dict:
    """Train as the flags say; returns a summary: per step its loss, frames,
    shape, seconds, host seconds for the loader and the copy, and logged
    MFU; the saves, validations and the OOM scan's shapes; the loader path,
    the checkpoint resumed from, the peak device memory and the final
    ``state``."""
    dev = resolve_device(None if args.device == "cuda" else args.device)
    grouped = dist.initialize(args.coordinator_address, args.num_processes, args.process_id,
                              device=args.device, backend=args.dist_backend,
                              force=bool(args.coordinator_address))
    try:
        return _run(args, dist.local_device(args.device) if grouped else dev, grouped)
    finally:
        if grouped:
            dist.shutdown()


def _run(args, dev, grouped: bool) -> dict:
    mesh = Mesh()  # data parallel over the process group; one rank without one
    handlers = [logging.StreamHandler()]
    args.exp_dir.mkdir(parents=True, exist_ok=True)
    if mesh.is_primary:
        handlers.append(logging.FileHandler(args.exp_dir / "log.txt"))
    logging.basicConfig(
        level=logging.INFO if mesh.is_primary else logging.WARNING,
        format="%(asctime)s %(levelname)s %(message)s", handlers=handlers, force=True)
    if grouped:
        logging.info(f"distributed: process {mesh.rank}/{mesh.data} on {dev}")
    cfg = config_from_args(args)
    if cfg.model_name.lower() == "transformer" and args.train_stage != 0:
        raise ValueError("the Transformer baseline has no AR/NAR stages; use --train-stage 0")
    torch.manual_seed(args.seed)
    model = get_model(cfg, device=dev, training=True)
    replicate_(model, mesh)  # ranks that built other weights start from rank 0's
    logging.info(f"model config: {cfg}")

    collater = get_text_token_collater(str(args.manifest_dir / args.text_tokens))
    manifest = Manifest.load(args.manifest_dir / "manifest_train.jsonl.gz")
    dev_path = args.manifest_dir / "manifest_dev.jsonl.gz"
    dev_loader = None
    if dev_path.exists():
        dev_loader = TtsDataLoader(Manifest.load(dev_path), collater,
                                   max_duration=args.max_duration, num_buckets=2, shuffle=False,
                                   dataset_name=args.dataset or None)
        dev_loader.set_epoch(0)

    make_opt, clip = make_optimizer(args)
    lr_fn = get_lr_fn(args.scheduler_name, args.base_lr, decoder_dim=args.decoder_dim,
                      warmup_steps=args.warmup_steps)
    feature_transforms = []
    if args.enable_spec_aug:
        from valle_tpu_torch.data.transforms import SpecAugment

        feature_transforms.append(SpecAugment(time_warp_factor=args.spec_aug_time_warp_factor,
                                              seed=args.seed))
    loader = TtsDataLoader(
        manifest, collater, max_duration=args.max_duration, num_buckets=args.num_buckets,
        accum_steps=args.accumulate_grad_steps, seed=args.seed,
        dataset_name=args.dataset or None, min_duration=args.filter_min_duration,
        max_utt_duration=args.filter_max_duration, batch_quant=args.batch_quant,
        feature_transforms=feature_transforms, rank=mesh.data_index, world_size=mesh.data)
    logging.info(f"data loader path: {loader.dataset.loader_path}")

    # the JAX CLI draws one group for its init shapes; drawn here too, so that
    # SpecAugment's generator is where the JAX CLI's is
    loader.set_epoch(args.start_epoch)
    try:
        next(iter(loader))
    except StopIteration:
        raise SystemExit("the training loader yields zero accumulation groups: the corpus is "
                         "too small for accumulate-grad-steps at this --max-duration")

    state = init_train_state(model, make_opt, train_stage=args.train_stage,
                             with_model_avg=args.average_period > 0)
    params = dict(model.named_parameters(remove_duplicate=True))
    n_params = sum(p.numel() for p in params.values())
    logging.info(f"parameters: {n_params / 1e6:.1f}M")
    if mesh.is_primary:
        with open(args.exp_dir / "model.txt", "w") as f:
            f.write(f"{cfg}\n\nparameters: {n_params}\n\n")
            for name, p in params.items():
                f.write(f"{name}\t{tuple(p.shape)}\t{str(p.dtype).removeprefix('torch.')}\n")

    ckpt = CheckpointManager(args.exp_dir / "checkpoints", args.keep_last_k)
    meta: dict = {}
    latest = ckpt.latest()
    if args.init_checkpoint and latest is None:
        # weights only; the optimizer is built again from the loaded weights
        # (ScaledAdam keeps the RMS of the weights it was built with)
        from valle_tpu_torch.bin.infer import load_model_params

        model.load_state_dict(load_model_params(args.init_checkpoint, cfg, _variant(cfg)))
        replicate_(model, mesh)
        state.optimizer = make_opt(list(partition_params(model, args.train_stage)[0].values()))
        if state.model_avg is not None:
            with torch.no_grad():
                for name, avg in state.model_avg.items():
                    avg.copy_(params[name])
        logging.info(f"warm-started weights from {args.init_checkpoint}")
    if latest is not None:
        meta_path = ckpt.dir / f"{latest}.meta.json"
        prev_stage = (json.loads(meta_path.read_text()).get("train_stage")
                      if meta_path.exists() else None)
        state, meta = ckpt.restore(latest, state, make_optimizer=make_opt,
                                   from_stage=prev_stage, to_stage=args.train_stage)
        logging.info(f"resumed from {latest} (meta={list(meta)})")
        if "sampler_state" in meta:
            loader.load_state_dict(meta["sampler_state"])

    step_fn = make_train_step(lr_fn, train_stage=args.train_stage, clip_grad_norm=clip,
                              average_period=args.average_period, inf_check=args.inf_check,
                              mesh=mesh)
    eval_fn = make_eval_step(train_stage=args.train_stage)

    writer = None
    if args.tensorboard and mesh.is_primary:
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(str(args.exp_dir / f"tensorboard_stage{args.train_stage}"))
        except ImportError:
            pass

    tracker = MetricsTracker(reset_interval=200)
    start_epoch = int(meta.get("epoch", args.start_epoch))
    if latest is not None and latest.startswith("epoch-"):
        start_epoch += 1  # its epoch is finished: the reference's --start-epoch N+1
    profile_range = None
    prof = None
    if args.profile_steps:
        profile_range = tuple(int(x) for x in args.profile_steps.split(","))
    peak = mfu_peak(cfg.dtype, dev)

    summary = {"loader_path": loader.dataset.loader_path, "resumed_from": latest, "steps": [],
               "saves": [], "validations": [], "oom_scan": []}
    if args.oom_check:
        summary["oom_scan"] = scan_batch_shapes_for_oom(args, cfg, loader, state, dev)

    def save(kind: str, key: int, meta_: dict) -> None:
        (ckpt.save_step if kind == "step" else ckpt.save_epoch)(key, state, meta_)
        summary["saves"].append(dict(ckpt.last_save))
        logging.info(f"saved {ckpt.last_save['name']} ({ckpt.last_save['bytes'] / 2**30:.2f} "
                     f"GiB in {ckpt.last_save['seconds']:.2f} s)")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step = state.step
    for epoch in range(start_epoch, args.num_epochs + 1):
        loader.set_epoch(epoch)
        skip = loader.pending_skip()
        consumed = 0
        t_last = time.time()
        flops_since_log = 0.0
        batches = iter(Prefetcher(iter(loader)))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            arrays = {k: v for k, v in batch.items()
                      if k not in ("utt_id", "text", "prompt_codes_lens")}
            if profile_range and state.step + 1 == profile_range[0]:
                prof = _start_profile(dev)
                logging.info(f"profiler trace started (steps {profile_range})")
            a_, b_, s_ = arrays["text_tokens"].shape
            t_ = arrays["audio_features"].shape[2]
            flops_since_log += train_step_flops(cfg, a_, b_, s_, t_, args.train_stage)
            tensors = to_device(arrays, dev)
            t2 = time.perf_counter()
            try:
                state, metrics = step_fn(state, tensors, step_generator(args.seed, state.step),
                                         epoch)
                lr = float(metrics.pop("lr"))  # a host value; the rest sync once
                values = torch.stack([v.float() for v in metrics.values()]).tolist()
                metrics = dict(zip(metrics, values), lr=lr)
                step = state.step
                tracker.update(metrics)
            except Exception as e:
                # the batch that failed, for a look at it later
                rank = f"-rank{mesh.rank}" if grouped else ""
                dump = args.exp_dir / f"batch-crash-step{state.step}{rank}.npz"
                np.savez(dump, **arrays,
                         utt_id=np.array([u for row in batch["utt_id"] for u in row]))
                logging.error(f"step failed; batch dumped to {dump}")
                if isinstance(e, NonFiniteLoss):
                    from valle_tpu_torch.train.debug import nonfinite_report

                    micro = {k: v[0] for k, v in tensors.items()}
                    report = nonfinite_report(model, micro, train_stage=args.train_stage)
                    raise FloatingPointError(
                        f"non-finite loss at step {state.step + 1}: "
                        f"{ {k: float(v) for k, v in e.metrics.items()} }; {report}") from e
                raise
            consumed += 1
            t3 = time.perf_counter()
            summary["steps"].append({"step": step, "epoch": epoch, "loss": metrics["loss"],
                                     "frames": metrics["frames"], "step_s": t3 - t2,
                                     "data_s": t1 - t0, "copy_s": t2 - t1,
                                     "shape": [a_, b_, s_, t_]})

            if prof is not None and step >= profile_range[1]:
                _stop_profile(prof, args.exp_dir)
                prof, profile_range = None, None

            if step % args.log_interval == 0:
                dt = time.time() - t_last
                t_last = time.time()
                mfu = None if peak is None else flops_since_log / max(dt, 1e-9) / peak
                flops_since_log = 0.0
                mem = "" if dev.type != "cuda" else f" mem={_peak_memory(dev) / 2**30:.1f}GiB"
                logging.info(f"epoch {epoch} step {step} {tracker.summary()} "
                             f"({args.log_interval / max(dt, 1e-9):.2f} it/s, "
                             f"mfu={'n/a' if mfu is None else f'{mfu:.3f}'}{mem})")
                summary["steps"][-1]["mfu"] = mfu
                if writer:
                    for k, v in tracker.normalized().items():
                        writer.add_scalar(f"train/{k}", v, step)

            if args.save_every_n and step % args.save_every_n == 0:
                save("step", step, {"train_stage": args.train_stage, "epoch": epoch, "step": step,
                                    "train_loss": tracker.normalized().get("loss"),
                                    "sampler_state": loader.state_dict(skip + consumed)})

            if dev_loader is not None and step % args.valid_interval == 0:
                valid_loss = run_validation(eval_fn, state, dev_loader, dev, args,
                                            tag=f"step-{step}")
                summary["validations"].append({"step": step, "loss": valid_loss})
                logging.info(f"validation at step {step}: loss={valid_loss:.4f}")
                if writer:
                    writer.add_scalar("valid/loss", valid_loss, step)

        if prof is not None:  # training ended before the requested end step
            _stop_profile(prof, args.exp_dir)
            prof, profile_range = None, None
        valid_loss = (run_validation(eval_fn, state, dev_loader, dev, args, tag=f"epoch-{epoch}")
                      if dev_loader is not None else None)
        save("epoch", epoch, {"train_stage": args.train_stage, "step": state.step,
                              "train_loss": tracker.normalized().get("loss"),
                              "valid_loss": valid_loss,
                              "sampler_state": loader.state_dict(skip + consumed)})
        logging.info(f"epoch {epoch} done")
    summary["peak_mem_bytes"] = _peak_memory(dev)
    summary["state"] = state
    return summary


def _start_profile(dev):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profile(prof, exp_dir: Path) -> None:
    prof.__exit__(None, None, None)
    out = exp_dir / "profile"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    logging.info(f"profiler trace written to {out}")


def scan_batch_shapes_for_oom(args, cfg, loader, state, dev) -> list:
    """Pre-flight: one forward and backward per distinct (S, T, B) batch
    shape of the epoch, on random inputs, with no optimizer step (the
    reference's ``scan_pessimistic_batches_for_oom``).  It uses its own
    generator, zeroes the gradients after each shape and puts the buffers
    back, so the weights, the optimizer and the training generator are as
    they were.  Logs and returns the peak device memory per shape."""
    sampler = loader.sampler
    shapes = sorted({(sampler.bucket_specs[b].max_text_len, sampler.bucket_specs[b].max_audio_len,
                      len(items)) for b, items in sampler._batches()})
    logging.info(f"OOM pre-scan over {len(shapes)} batch shapes")
    rng = np.random.RandomState(0)
    a = args.accumulate_grad_steps
    model = state.model
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    out = []
    for s, t, bsz in shapes:
        if loader.dataset.float_features:
            audio = rng.randn(a, bsz, t, cfg.num_mel_bins).astype(np.float32)
        else:
            audio = rng.randint(0, cfg.num_audio_tokens,
                                (a, bsz, t, cfg.num_quantizers)).astype(np.int32)
        arrays = {
            "text_tokens": rng.randint(1, cfg.num_text_tokens, (a, bsz, s)).astype(np.int32),
            "text_tokens_lens": np.full((a, bsz), s, np.int32),
            "audio_features": audio,
            "audio_features_lens": np.full((a, bsz), t, np.int32),
            "example_mask": np.ones((a, bsz), bool),
        }
        if args.dataset:
            arrays["prompt_codes"] = rng.randint(
                0, cfg.num_audio_tokens, (a, bsz, 3 * 75, cfg.num_quantizers)).astype(np.int32)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model.train()
        try:
            accumulate_gradients(model, to_device(arrays, dev), args.train_stage,
                                 torch.Generator().manual_seed(0))
        except Exception:
            logging.error(f"OOM-scan failure at shape B={bsz} S={s} T={t} (accum {a}); "
                          "reduce --max-duration")
            raise
        finally:
            state.optimizer.zero_grad(set_to_none=True)
            model.zero_grad(set_to_none=True)
            with torch.no_grad():
                for k, b in model.named_buffers():
                    b.copy_(buffers[k])
        peak = _peak_memory(dev)
        logging.info(f"  shape B={bsz} S={s} T={t}: peak {peak / 2**30:.2f} GiB")
        out.append({"b": bsz, "s": s, "t": t, "peak_mem_bytes": peak})
    return out


def run_validation(eval_fn, state, loader, dev, args=None, tag: str = "latest") -> float:
    """Loss per frame over the dev loader; every batch draws the NAR stage
    from a generator seeded 0, as the JAX CLI passes one key to every batch.
    Under ``args.visualize`` (not for the Transformer baseline) the first
    batch's PNGs go to ``<exp-dir>/eval/<tag>``."""
    tot, frames = 0.0, 0.0
    first = None
    for batch in loader:
        micro = to_device({k: v[0] for k, v in batch.items()
                           if k not in ("utt_id", "text", "prompt_codes_lens")}, dev)
        out = eval_fn(state.model, micro, torch.Generator().manual_seed(0))
        tot += float(out["loss"])
        frames += float(out["frames"])
        if first is None:
            first = batch
    if (args is not None and args.visualize and first is not None and dist.is_primary()
            and args.model_name.lower() != "transformer"):
        visualize_batch(state.model, first, dev, args.exp_dir / "eval" / tag)
    return tot / max(frames, 1.0)


VISUALIZE_KEYS = ("text_tokens", "text_tokens_lens", "audio_features", "audio_features_lens")


def visualize_batch(model, batch: dict, dev, out_dir: Path) -> None:
    """The PNGs of micro-batch 0 of a loader ``batch``: the model's
    ``visualize_forward`` on ``dev``, then ``models/visualizer.py``."""
    from valle_tpu_torch.models.visualizer import visualize

    arrays = {k: batch[k][0] for k in VISUALIZE_KEYS}
    tensors = to_device(arrays, dev)
    enc, dec = model.visualize_forward(*(tensors[k] for k in VISUALIZE_KEYS))
    visualize((enc.float().cpu().numpy(), dec.float().cpu().numpy()),
              dict(arrays, utt_id=batch["utt_id"][0], text=batch["text"][0]), str(out_dir))


def main(argv=None) -> dict:
    return run(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
