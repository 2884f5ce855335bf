"""Non-finite (inf / nan) localisation for ``--inf-check``: the twin of
``valle_tpu/train/debug.py``.

The hot step checks only the loss.  When it is not finite, the trainer
re-runs the batch's first micro-batch once in eval mode with a forward hook
on every submodule (where JAX captures the intermediates of a flax apply),
and names the first module whose output is not finite, beside the
parameters that hold an inf or a nan.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def find_nonfinite_params(model: torch.nn.Module) -> List[str]:
    """Names of the parameters holding an inf or a nan."""
    return [name for name, p in model.named_parameters()
            if p.is_floating_point() and not bool(torch.isfinite(p).all())]


def _nonfinite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and not bool(torch.isfinite(out).all())
    if isinstance(out, (tuple, list)):
        return any(_nonfinite(o) for o in out)
    if isinstance(out, dict):
        return any(_nonfinite(o) for o in out.values())
    return False


def localize_nonfinite_forward(model: torch.nn.Module, micro: Dict[str, torch.Tensor], *,
                               train_stage: int = 0) -> List[str]:
    """Re-run one micro-batch (no leading A axis) in eval mode with a hook
    on every submodule; the names of the modules whose outputs are not
    finite, in the order they ran: the first one is the culprit, the rest
    are contaminated by it."""
    bad: List[str] = []
    handles = []
    for name, mod in model.named_modules():
        if not name:
            continue

        def hook(_mod, _inp, out, name=name):
            if _nonfinite(out):
                bad.append(name)

        handles.append(mod.register_forward_hook(hook))
    kw = {}
    if "prompt_codes" in micro:
        kw["y_prompts_codes"] = micro["prompt_codes"]
    if "example_mask" in micro:
        kw["example_mask"] = micro["example_mask"]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(micro["text_tokens"], micro["text_tokens_lens"], micro["audio_features"],
                  micro["audio_features_lens"], train_stage=train_stage,
                  rng=torch.Generator().manual_seed(0), **kw)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return bad


def nonfinite_report(model: torch.nn.Module, micro: Dict[str, torch.Tensor], *,
                     train_stage: int = 0) -> str:
    """The trainer's ``--inf-check`` message."""
    lines = []
    bad_params = find_nonfinite_params(model)
    if bad_params:
        lines.append(f"non-finite params: {bad_params[:10]}")
    bad_mods = localize_nonfinite_forward(model, micro, train_stage=train_stage)
    if bad_mods:
        lines.append(f"first non-finite module output: {bad_mods[0]}")
        if len(bad_mods) > 1:
            lines.append(f"(contaminated downstream: {bad_mods[1:6]} ...)")
    if not lines:
        lines.append("re-run was finite (non-determinism or optimizer-transient); "
                     "no module localized")
    return "; ".join(lines)
