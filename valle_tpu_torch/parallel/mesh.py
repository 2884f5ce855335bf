"""A (data, model) mesh of process groups and the sharding rules: the twin
of ``valle_tpu/parallel/mesh.py``.

JAX lays its devices out as a ``(data, model)`` mesh and GSPMD inserts the
collectives.  Here the mesh is of ranks, one per card, in the same row-major
order: rank r is data shard ``r // model`` and model shard ``r % model``.
Each rank belongs to one data group (the ranks that hold the same model
shard, over which a batch is split and gradients are summed) and one model
group (the ranks of one data shard, over which the weights are split).

  - Data parallelism: each rank takes its rows of a batch (``shard_batch``;
    a training loader is already rank-sharded, so its batch is used as it
    is, padded to the data group's widths by ``pad_to_group_widths``), and
    ``replicate_`` makes the weights equal across the data group.
  - Tensor parallelism (Megatron, ``shard_parameters_``): the packed
    attention in-projections and ``linear1`` keep the output rows of this
    rank's heads or features (column parallel); ``out_proj`` and
    ``linear2`` keep the matching input columns (row parallel) and sum
    their partial products over the model group before the bias.  int8
    weights carry their per-output-row scales along: sliced with a
    column-parallel weight, whole with a row-parallel one, as
    ``quantized_shardings`` places them.  The embeddings, norms and
    prediction heads stay whole on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.distributed as tdist

from valle_tpu_torch.parallel import dist

COLUMN_PARALLEL = ("linear1",)
ROW_PARALLEL = ("linear2",)


def layout(rank: int, data: int, model: int) -> Dict:
    """Rank ``rank``'s place in a ``data x model`` mesh: its data and model
    shard indices and the ranks of its data and model groups."""
    d, t = divmod(rank, model)
    return {"data_index": d, "model_index": t,
            "data_ranks": [i * model + t for i in range(data)],
            "model_ranks": [d * model + j for j in range(model)]}


class Mesh:
    """The ``data x model`` mesh over the ranks of the process group (or a
    stand-alone rank ``rank`` of it without one, whose groups are None)."""

    def __init__(self, data: Optional[int] = None, model: int = 1, *, rank: Optional[int] = None):
        world = dist.process_count() if rank is None else data * model
        data = world // model if data is None else data
        if data * model != world:
            raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, have {world}")
        self.data, self.model = data, model
        self.rank = dist.process_index() if rank is None else rank
        place = layout(self.rank, data, model)
        self.data_index, self.model_index = place["data_index"], place["model_index"]
        self.data_group = self.model_group = None
        if rank is None and tdist.is_initialized():
            # every rank makes every group, in the same order
            for i in range(model):
                g = tdist.new_group(layout(i, data, model)["data_ranks"])
                if i == self.model_index:
                    self.data_group = g
            for i in range(data):
                g = tdist.new_group(layout(i * model, data, model)["model_ranks"])
                if i == self.data_index:
                    self.model_group = g

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict:
    """This rank's rows of every array of ``batch``: rows ``[d b / D, (d +
    1) b / D)`` of data shard d.  ``b`` must divide by D (the serve CLI pads
    its batches so)."""
    out = {}
    for k, a in batch.items():
        if len(a) % mesh.data:
            raise ValueError(f"{k}: {len(a)} rows do not split over {mesh.data} data shards")
        n = len(a) // mesh.data
        out[k] = a[mesh.data_index * n: (mesh.data_index + 1) * n]
    return out


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data shards' rows of ``t`` (dim 0) in shard order: the inverse of
    ``shard_batch``."""
    return dist.all_gather(t, mesh.data_group)


def replicate_(model: torch.nn.Module, mesh: Mesh) -> int:
    """Make every parameter and buffer of ``model`` that of data shard 0,
    over the data group; returns the bytes broadcast."""
    tensors = [t.data for t in (*model.parameters(), *model.buffers())]
    with torch.no_grad():
        return dist.coalesced_(tensors, "broadcast", mesh.data_group)


def shard_parameters_(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Slice ``model``'s weights in place to this rank's model shard (module
    docstring; a no-op at ``mesh.model == 1``): every attention module
    (``MultiheadAttention.shard_heads_``), the ``linear1`` and ``linear2``
    of every layer.  Returns the model."""
    if mesh.model == 1:
        return model
    for path, mod in model.named_modules():
        name = path.rsplit(".", 1)[-1]
        if hasattr(mod, "shard_heads_"):
            mod.shard_heads_(mesh.model_index, mesh.model, mesh.model_group)
        elif name in COLUMN_PARALLEL:
            mod.shard_outputs_(mesh.model_index, mesh.model)
        elif name in ROW_PARALLEL:
            mod.shard_inputs_(mesh.model_index, mesh.model, mesh.model_group)
    return model


WIDTH_KEYS = ("text_tokens", "audio_features")  # (A, B, width, ...) arrays of a train batch


def pad_to_group_widths(batch: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """``batch`` (this rank's part of a training batch) with its text and
    audio padded with zeros to the widest over ``group``: the ranks' parts
    then have the widths of the global batch they make up, which the
    forward's width-bound quantities (the AR loss's EOS positions up to the
    longest length, prefix mode 2's prompt cap) need, as the ranks of a
    bucketing loader may hold batches of other buckets.  The padding lies
    past every length, so it is masked."""
    if group is None:
        return batch
    widths = dist.reduce_ints([batch[k].shape[2] for k in WIDTH_KEYS], "max", group)
    out = dict(batch)
    for k, w in zip(WIDTH_KEYS, widths):
        a = batch[k]
        if a.shape[2] < w:
            out[k] = torch.cat([a, a.new_zeros((*a.shape[:2], w - a.shape[2], *a.shape[3:]))], 2)
    return out


@contextlib.contextmanager
def global_batch(model: torch.nn.Module, group):
    """Within the block, ``model``'s forward takes its batch as this rank's
    part of a batch split over ``group``: its shared random draws (the NAR
    stage) are the group's first rank's, and its batch-wide quantities (the
    longest and shortest lengths, the frame and row counts of a mean or a
    rescale) are the whole batch's, as the JAX forward computes them over
    its global batch (``models/valle.py``, ``models/transformer_tts.py``)."""
    prev = getattr(model, "batch_group", None)
    model.batch_group = group
    try:
        yield
    finally:
        model.batch_group = prev
