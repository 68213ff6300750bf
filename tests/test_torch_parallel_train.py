"""Port parity: the dense TP and SP training steps of petit_kernel_tpu_torch
(parallel/tp.py make_tp_forward and make_tp_forward_sp over
shard_dense_params shards, loss.backward() on every rank) against
jax.value_and_grad over the JAX package's GSPMD-sharded params, the JAX
dry run's steps (1) and (3) (__graft_entry__.py), on the CPU.

The port's ranks are spawned processes (tests/_torch_parallel_ranks.py:
gloo over a file store, "cpu" DeviceMeshes), one group of 2 ranks and one
of 4, each started once for the file, at (dp, tp) = (1, 2), (2, 2) and
(1, 4). The JAX package runs on this process's 8 virtual CPU devices.
tests/test_parallel.py:160's dense config with 2 layers; tokens (4, 17)
from default_rng(0), so that every row and position carries a gradient;
the loss is the dry run's, the mean NLL of tokens[:, 1:] under the logits
of tokens[:, :-1] (16 positions, which split over tp for the SP forward).

Tolerances: the loss within rtol 1e-3 and each gradient within 2^-5 *
max|JAX gradient| of the matching slice of JAX's, the bounds of
tests/test_torch_train.py::test_llama_loss_and_grads_match_jax; the shards
after one SGD step (w - 1e-3 g in bf16, the dry run's update) within one
bf16 ulp of w (the two updates may round to neighbours) plus the rate
times the gradient bound. A gradient scaled by tp or dp, the fault a wrong
collective backward makes, is off by 100% or more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_parallel_ranks as ranks
from petit_kernel_tpu import parallel as jpar
from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu_torch.models import convert

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CFG = jllama.LlamaConfig(
    vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=8, num_kv_heads=4, head_dim=16, max_seq_len=32)
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
_ALL_MESHES = [m for w in MESHES.values() for m in w]
KINDS = ("tp", "sp")
LR = 1e-3
_COL = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW = ("wo", "w_down")


def _jmesh(dp, tp):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("dp", "tp"))


def _loss_fn(p, toks):
    """The JAX dry run's loss (__graft_entry__.py:96)."""
    logits, _ = jllama.forward(p, toks[:, :-1], CFG)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    nll = -jnp.take_along_axis(logp, toks[:, 1:][..., None], -1)
    return nll.mean()


@pytest.fixture(scope="module")
def train_setup(tmp_path_factory):
    """JAX params and tokens, and the two spawned rank groups, started at
    once so that they run while the JAX references compute."""
    dense = jllama.init_params(CFG, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, CFG.vocab_size, size=(4, 17)).astype(np.int32)
    inputs = {
        "cfg": dataclasses.asdict(CFG), "meshes": MESHES, "lr": LR,
        "dense": convert.params_from_jax(jax.tree.map(np.asarray, dense),
                                         device="cpu"),
        "tokens": torch.from_numpy(tokens),
    }
    runs = {w: ranks.start("train", w, inputs,
                           str(tmp_path_factory.mktemp(f"train{w}")))
            for w in MESHES}
    yield dict(dense=dense, tokens=tokens, runs=runs)
    for run in runs.values():
        ranks.finish(run)


@pytest.fixture(scope="module")
def jax_steps(train_setup):
    """At each mesh: jax.value_and_grad of the loss over
    shard_dense_params (tokens sharded over "dp") and the dry run's SGD
    update, every array gathered to numpy."""
    out = {}
    for dp, tp in _ALL_MESHES:
        mesh = _jmesh(dp, tp)
        params_sh = jpar.shard_dense_params(train_setup["dense"], mesh)
        toks = jax.device_put(jnp.asarray(train_setup["tokens"]),
                              NamedSharding(mesh, P("dp", None)))
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(_loss_fn))(params_sh,
                                                                toks)
        new = jax.tree.map(lambda w, g: w - LR * g.astype(w.dtype),
                           params_sh, grads)
        out[dp, tp] = dict(loss=float(loss),
                           grads=jax.tree.map(np.asarray, grads),
                           new=jax.tree.map(np.asarray, new),
                           old=jax.tree.map(np.asarray, params_sh))
    return out


def _slices(tree, tp: int, t: int) -> dict:
    """{path: rank t's slice} of a whole-model tree (numpy leaves): the
    column block of _COL and lm_head, the row block of _ROW, the rest
    whole."""
    def cut(x, axis):
        n = x.shape[axis] // tp
        return np.take(x, np.arange(t * n, (t + 1) * n), axis=axis)

    out = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "lm_head/w": cut(tree["lm_head"]["w"], 1)}
    for i, lp in enumerate(tree["layers"]):
        for k in ("attn_norm", "mlp_norm"):
            out[f"layers/{i}/{k}"] = lp[k]
        for k in _COL:
            out[f"layers/{i}/{k}/w"] = cut(lp[k]["w"], 1)
        for k in _ROW:
            out[f"layers/{i}/{k}/w"] = cut(lp[k]["w"], 0)
    return out


def _flat(tree, path="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _mesh_id(m):
    return f"{m[0]}x{m[1]}"


def _rank_runs(setup, mesh, kind):
    dp, tp = mesh
    res = ranks.finish(setup["runs"][dp * tp])
    return [r[f"{kind} {dp}x{tp}"] for r in res]


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("kind", KINDS)
def test_train_loss_matches_jax(train_setup, jax_steps, kind, mesh):
    """Every rank's loss of the TP (or SP) forward's logits equals JAX's
    value_and_grad loss within rtol 1e-3; the forward was recorded."""
    want = jax_steps[mesh]["loss"]
    for run in _rank_runs(train_setup, mesh, kind):
        assert run["logits_grad_fn"]
        np.testing.assert_allclose(run["loss"], want, rtol=1e-3)


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("kind", KINDS)
def test_train_grads_are_slices_of_jax_grads(train_setup, jax_steps, kind,
                                             mesh):
    """Every rank's gradient of every local leaf equals the rank's slice
    of JAX's unsharded gradient within 2^-5 * max|JAX gradient|:
    column-parallel leaves their columns, row-parallel leaves their rows,
    embed and the norms whole."""
    dp, tp = mesh
    want_all = jax_steps[mesh]["grads"]
    for run in _rank_runs(train_setup, mesh, kind):
        want = _slices(want_all, tp, run["tp_rank"])
        got = _flat(run["grads"])
        assert set(got) == set(want)
        for path, w in want.items():
            w = np.asarray(w, np.float32)
            g = got[path]
            assert g is not None, path
            g = g.float().numpy()
            assert g.shape == w.shape, path
            err = np.abs(g - w).max()
            bound = 2 ** -5 * np.abs(w).max()
            assert np.isfinite(g).all() and err <= bound, (
                f"{kind} {mesh} rank {run['tp_rank']} {path}: max abs err "
                f"{err} > {bound}")


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("kind", KINDS)
def test_sgd_step_updates_the_slices_of_jax_update(train_setup, jax_steps,
                                                   kind, mesh):
    """One SGD step's updated shards (w - 1e-3 g, bf16) equal the slices
    of the JAX dry run's updated params within one bf16 ulp of the weight
    plus the rate times the gradient bound; the weights moved."""
    dp, tp = mesh
    ref = jax_steps[mesh]
    for run in _rank_runs(train_setup, mesh, kind):
        t = run["tp_rank"]
        want = _slices(ref["new"], tp, t)
        old = _slices(ref["old"], tp, t)
        grads = _slices(ref["grads"], tp, t)
        got = _flat(run["new"])
        assert set(got) == set(want)
        moved = 0
        for path, w in want.items():
            w = np.asarray(w, np.float32)
            o = np.asarray(old[path], np.float32)
            g = got[path]
            assert g.dtype == torch.bfloat16, path
            g = g.float().numpy()
            bound = (2 ** -7 * np.abs(o) + LR * 2 ** -5
                     * np.abs(np.asarray(grads[path], np.float32)).max())
            assert (np.abs(g - w) <= bound).all(), (kind, mesh, path)
            moved += int((g != o).sum())
        assert moved > 0


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=_mesh_id)
def test_frozen_shards_run_under_inference_mode(train_setup, mesh):
    """Over shards that require no grad, make_tp_forward and
    make_tp_forward_sp run under torch.inference_mode: their logits are
    inference tensors."""
    dp, tp = mesh
    for r in ranks.finish(train_setup["runs"][dp * tp]):
        assert r[f"frozen {dp}x{tp}"] == [True, True]
