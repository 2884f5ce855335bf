"""The port's parallel layer in one process (``valle_tpu_torch/parallel``):

  - the mesh's rank layout (row-major, as ``valle_tpu.parallel.mesh``
    places its devices) for D x T in {2x1, 1x2, 2x2};
  - ``shard_parameters_``: the T shards of every sharded weight (the packed
    attention in-projections, ``out_proj``, ``linear1``, ``linear2``) put
    back together equal the whole model's, in f32 and with int8 weights and
    their scales; the in-projection slices are head-aligned (rank t holds q,
    k and v of heads [t H / T, (t + 1) H / T)); everything else stays whole;
  - ``shard_batch`` takes shard d's rows;
  - ``draw_seed``: unchanged at rank 0, another seed at rank 1.

The collectives run over gloo in ``tests/test_torch_multiprocess_train.py``
and ``tests/test_torch_sharded_generate.py``.
"""

import pytest
import torch

from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.ops.philox import draw_seed, fold_rank
from valle_tpu_torch.parallel.mesh import Mesh, layout, shard_batch, shard_parameters_

KW = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=3)


@pytest.mark.parametrize("data,model,want", [
    (2, 1, [(0, 0, [0, 1], [0]), (1, 0, [0, 1], [1])]),
    (1, 2, [(0, 0, [0], [0, 1]), (0, 1, [1], [0, 1])]),
    (2, 2, [(0, 0, [0, 2], [0, 1]), (0, 1, [1, 3], [0, 1]),
            (1, 0, [0, 2], [2, 3]), (1, 1, [1, 3], [2, 3])]),
])
def test_mesh_layout(data, model, want):
    for rank, (d, t, data_ranks, model_ranks) in enumerate(want):
        assert layout(rank, data, model) == {"data_index": d, "model_index": t,
                                             "data_ranks": data_ranks, "model_ranks": model_ranks}
        mesh = Mesh(data, model, rank=rank)
        assert (mesh.data_index, mesh.model_index) == (d, t)
        assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="needs"):
        Mesh(3, 2)  # one process without a group


def _model(quantize: bool, variant: str = "VALL-E"):
    torch.manual_seed(0)
    cfg = ModelConfig(model_name=variant, act_quant=quantize, **KW)
    return get_model(cfg, device="cpu", quantize=quantize)


def _shards(quantize: bool, size: int, variant: str = "VALL-E"):
    full = _model(quantize, variant).state_dict()
    parts = []
    for t in range(size):
        model = _model(quantize, variant)
        shard_parameters_(model, Mesh(1, size, rank=t))
        parts.append(model)
    return full, parts


COLUMN_KEYS = ("in_proj_weight", "in_proj_bias", "in_proj_weight_scale", "linear1.weight",
               "linear1.bias", "linear1.weight_scale")
ROW_KEYS = ("out_proj.weight", "linear2.weight")


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("variant", ["VALL-E", "VALL-F"])
def test_shards_put_together_equal_the_whole_model(quantize, variant):
    size, h = 2, KW["nhead"]
    full, parts = _shards(quantize, size, variant)
    dicts = [m.state_dict() for m in parts]
    sharded = 0
    for key, want in full.items():
        got = [sd[key] for sd in dicts]
        if key.endswith(COLUMN_KEYS) and "in_proj" in key:
            # head-aligned: rank t holds q, k and v rows of its heads
            d = want.shape[0] // 3
            dh = d // h
            for t, g in enumerate(got):
                lo, hi = t * (h // size) * dh, (t + 1) * (h // size) * dh
                want_t = torch.cat([want[blk * d + lo: blk * d + hi] for blk in range(3)])
                assert torch.equal(g, want_t), key
            sharded += 1
        elif key.endswith(COLUMN_KEYS):
            assert torch.equal(torch.cat(got, 0), want), key
            sharded += 1
        elif key.endswith(ROW_KEYS):
            assert torch.equal(torch.cat(got, 1), want), key
            sharded += 1
        else:  # replicated: embeddings, norms, heads, row-parallel biases and scales
            assert all(torch.equal(g, want) for g in got), key
    # per attention block: in_proj weight, bias (and scale), out_proj weight;
    # per FFN: linear1 weight, bias (and scale), linear2 weight
    attentions = 2 if variant == "VALL-F" else 1
    per_layer = (3 + quantize) * attentions + 3 + quantize
    assert sharded == 2 * KW["num_layers"] * per_layer, sharded
    attn = parts[0].ar_decoder.layers[0].self_attn
    assert attn.local_heads == h // size and attn.head_dim == KW["decoder_dim"] // h
    assert attn.out_proj.tp_group is None  # no process group here
    assert parts[0].ar_decoder.layers[0].linear1.out_features == 4 * KW["decoder_dim"] // size


def test_shard_refuses_heads_that_do_not_split():
    with pytest.raises(ValueError, match="split over 3"):
        shard_parameters_(_model(False), Mesh(1, 3, rank=0))


def test_shard_batch_takes_the_shards_rows():
    batch = {"x": torch.arange(8).view(8, 1), "y": torch.arange(16).view(8, 2)}
    for d in range(2):
        got = shard_batch(batch, Mesh(2, 1, rank=d))
        assert got["x"].flatten().tolist() == list(range(4 * d, 4 * d + 4))
        got = shard_batch(batch, Mesh(2, 2, rank=2 * d + 1))  # model shard 1 of data shard d
        assert got["y"].flatten().tolist() == list(range(8 * d, 8 * d + 8))
    with pytest.raises(ValueError, match="do not split"):
        shard_batch({"x": torch.zeros(3)}, Mesh(2, 1, rank=0))


def test_draw_seed_folds_the_rank():
    a = draw_seed(torch.Generator().manual_seed(5))  # no group: rank 0, unfolded
    assert a == int(torch.randint(0, 2**63 - 1, (), generator=torch.Generator().manual_seed(5)))
    assert fold_rank(a, 0) == a
    b = fold_rank(a, 1)
    assert b != a and 0 <= b < 2**63 - 1
    assert len({fold_rank(a, r) for r in range(64)}) == 64
