"""Data-parallel training of the port over gloo on the CPU, the counterpart
of ``tests/test_multiprocess_train.py``: two rank processes
(``tests/torch_ranks.py``), each with half of an A=2, B=8 batch at dropout 0
(``deterministic``), take one step through the parallel layer
(``make_train_step(..., mesh=...)``), and are held against the port's
single-process step on the whole batch for VALL-E stage 1, stage 2 (prefix
modes 0 and 1) and the Transformer TTS baseline:

  - the loss within rtol 1e-5; the gradients the optimizer gets (summed
    over the ranks) within 1e-5 of the single-process ones, relative to
    each tensor's norm;
  - the updated weights by their checksum (sum of |w|) at rtol 1e-5, as the
    JAX test holds them: at ScaledAdam's first step an element whose
    gradient is near 0 flips its sign under another summation order and
    moves by twice the step, so the weights are not compared one by one;
    the two ranks' weights are equal bit for bit;
  - VALL-E stage 1 also against JAX's ``make_train_step`` on the whole
    batch (the same weights through ``utils/bridge.py``), under one jit.

Also: the NAR stages of both ranks are equal where their batch sizes differ
(prefix mode 2 draws per-row prompt starts between the stages); a group of
one (``--num-processes 1`` with a coordinator address) trains bit for bit as
no group, through the train CLI; and the train CLI as two processes on a
small corpus trains an epoch, writes one set of checkpoints and a second run
resumes from them.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_ranks
from tests.torch_corpus import write_corpus
from tests.torch_ranks import (PARITY_CASES, TRAIN_KW, WIDTH_CASES, run_processes, run_ranks,
                               train_batch, train_step_result)
from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.optim import eden_lr as jax_eden
from valle_tpu.optim import scaled_adam, valle_batched_axis
from valle_tpu.train.step import init_train_state as jax_init_train_state
from valle_tpu.train.step import make_train_step as jax_make_train_step
from valle_tpu_torch.data import CodeShardWriter, Manifest, SymbolTable
from valle_tpu_torch.models import ModelConfig
from valle_tpu_torch.parallel import dist
from valle_tpu_torch.utils.bridge import state_dict_from_jax

LOSS_RTOL = GRAD_RTOL = CHECKSUM_RTOL = 1e-5
JAX_KW = {k: TRAIN_KW[k] for k in ("decoder_dim", "nhead", "num_layers", "num_quantizers")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A seeded JAX VALL-E's params, bridged into a port state dict file."""
    model = JaxVALLE(JaxConfig(**JAX_KW))
    batch = train_batch("valle_stage1")
    x, x_lens, y, y_lens = (jnp.asarray(batch[k][0].numpy()) for k in (
        "text_tokens", "text_tokens_lens", "audio_features", "audio_features_lens"))
    variables = jax.jit(lambda k: model.init({"params": k, "stage": k}, x, x_lens, y, y_lens,
                                             train_stage=0, deterministic=True,
                                             nar_stage=jnp.asarray(1)))(jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    path = tmp_path_factory.mktemp("weights") / "valle.pt"
    torch.save(state_dict_from_jax(variables, ModelConfig(**TRAIN_KW), device="cpu"), path)
    return str(path), variables


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    out = tmp_path_factory.mktemp("ranks")
    run_ranks("train_job", 2, out, weights[0])
    return out


def _grad_errors(got: dict, want: dict) -> dict:
    assert got.keys() == want.keys()
    return {k: float((got[k] - want[k]).norm() / want[k].norm().clamp(min=1e-30))
            for k in want}


@pytest.mark.parametrize("case", PARITY_CASES)
def test_two_ranks_equal_the_single_process_step(ranks, weights, case):
    _assert_step_parity(ranks, weights, case, "", train_batch(case))


@pytest.mark.parametrize("case", WIDTH_CASES)
def test_ranks_of_other_widths_equal_the_single_process_step(ranks, weights, case):
    """Rank 1's half is narrower than rank 0's (text and audio cut to its
    longest lengths): the step pads it to the group's widths, so the AR
    loss's EOS targets reach the whole batch's longest length."""
    _assert_step_parity(ranks, weights, case, "_narrow", train_batch(case, narrow=True))


def _assert_step_parity(ranks, weights, case, tag, batch):
    r0, r1 = (torch.load(ranks / f"{case}{tag}_rank{r}.pt") for r in range(2))
    want = train_step_result(case, weights[0], batch)
    assert r0["loss"] == r1["loss"] and r0["frames"] == r1["frames"] == want["frames"]
    assert torch.equal(r0["gen_state"], want["gen_state"])  # the same draws were taken
    for name, t in r0["weights"].items():
        assert torch.equal(t, r1["weights"][name]), name
    np.testing.assert_allclose(r0["loss"], want["loss"], rtol=LOSS_RTOL)
    errors = _grad_errors(r0["grads"], want["grads"])
    worst = max(errors, key=errors.get)
    assert errors[worst] <= GRAD_RTOL, (worst, errors[worst])
    assert sum(float(g.abs().sum()) for g in want["grads"].values()) > 0
    np.testing.assert_allclose(r0["checksum"], want["checksum"], rtol=CHECKSUM_RTOL)


def test_stage_1_equals_the_jax_step(ranks, weights):
    jmodel = JaxVALLE(JaxConfig(**JAX_KW))
    tx = scaled_adam(learning_rate=0.02, clipping_scale=2.0, betas=(0.9, 0.95),
                     show_dominant_parameters=False, batched_axis_fn=valle_batched_axis)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in train_batch("valle_stage1").items()}
    state = jax_init_train_state(jmodel, tx, jax.random.PRNGKey(0),
                                 jax.tree.map(lambda v: v[0], jbatch), train_stage=1)
    state = state.replace(params=jax.tree.map(jnp.asarray, weights[1]["params"]))
    step = jax_make_train_step(jmodel, tx, lambda s, e: jax_eden(0.05, s, e), train_stage=1,
                               deterministic=True)
    state, metrics = step(state, jbatch, jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
    checksum = float(sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(state.params)))
    got = torch.load(ranks / "valle_stage1_rank0.pt")
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["checksum"], checksum, rtol=CHECKSUM_RTOL)


def test_nar_stages_agree_where_batch_sizes_differ(ranks):
    """The ranks' NAR stages (prefix modes 2 and 1) and mode 1's prefix
    lengths are rank 0's draws, though the ranks' own draws differ."""
    s0, s1 = (json.loads((ranks / f"stages_rank{r}.json").read_text()) for r in range(2))
    a = torch_ranks.A
    assert len(s0["stages"]) == len(s1["stages"]) == 2 * a
    assert s0["stages"] == s1["stages"]
    # a stage per micro-batch in mode 2, a stage and a prefix length per
    # micro-batch in mode 1
    assert len(s0["draws"]) == len(s1["draws"]) == 3 * a
    used = [d[1] for d in s0["draws"]]
    assert used == [d[0] for d in s0["draws"]] == [d[1] for d in s1["draws"]]
    assert [d[0] for d in s0["draws"]] != [d[0] for d in s1["draws"]]


# ------------------------------------------------------------- the train CLI

DIMS = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers", "2"]
FLAGS = ["--device", "cpu", "--tensorboard", "false", "--log-interval", "1", "--max-duration",
         "3", "--num-buckets", "1", "--batch-quant", "1", "--oom-check", "false",
         "--valid-interval", "1000", "--save-every-n", "2", "--keep-last-k", "1",
         "--dropout", "0.1", "--average-period", "1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"), writer_cls=CodeShardWriter,
                        manifest_cls=Manifest, table_cls=SymbolTable,
                        splits=(("train", 24), ("dev", 4)))


def _train_argv(corpus, exp, *extra):
    return [sys.executable, "-m", "valle_tpu_torch.bin.train", "--manifest-dir",
            str(corpus), "--exp-dir", str(exp), *DIMS, *FLAGS, *extra]


def _cli_ranks(corpus, exp, world, *extra):
    address = f"127.0.0.1:{dist.free_port()}"
    return run_processes([_train_argv(corpus, exp, "--num-processes", str(world),
                                      "--process-id", str(r), "--coordinator-address", address,
                                      *extra) for r in range(world)])


def test_group_of_one_trains_as_no_group(corpus, tmp_path):
    """The same run with no group and through a gloo group of one: the
    same log lines of losses, bit for bit, and equal checkpoints."""
    run_processes([_train_argv(corpus, tmp_path / "plain", "--num-epochs", "1")])
    _cli_ranks(corpus, tmp_path / "grouped", 1, "--num-epochs", "1")
    logs = [(tmp_path / d / "log.txt").read_text() for d in ("plain", "grouped")]
    steps = [[line.split(" INFO ")[1].split(" (")[0] for line in log.splitlines()
              if " step " in line] for log in logs]
    assert steps[0] == steps[1] and len(steps[0]) >= 4
    assert "distributed: process 0/1" in logs[1]
    a, b = (torch.load(tmp_path / d / "checkpoints" / "epoch-1.pt") for d in ("plain", "grouped"))
    for part in ("model", "model_avg"):
        for name, t in a[part].items():
            assert torch.equal(t, b[part][name]), (part, name)


def test_two_process_train_cli_saves_and_resumes(corpus, tmp_path):
    exp = tmp_path / "exp"
    _cli_ranks(corpus, exp, 2, "--num-epochs", "1")
    log = (exp / "log.txt").read_text()
    assert "distributed: process 0/2" in log and "epoch 1 done" in log
    assert "process 1/2" not in log  # rank 1 writes no log lines
    names = sorted(p.name for p in (exp / "checkpoints").iterdir())
    assert "epoch-1.pt" in names and sum(n.startswith("checkpoint-") for n in names) == 2, names
    steps = [line for line in log.splitlines() if " step " in line]
    assert steps and all("nan" not in line for line in steps)
    _cli_ranks(corpus, exp, 2, "--num-epochs", "2")
    log = (exp / "log.txt").read_text()
    assert "resumed from epoch-1" in log and "epoch 2 done" in log
