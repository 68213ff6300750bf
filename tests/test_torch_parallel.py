"""Port parity: tensor parallelism of petit_kernel_tpu_torch (parallel/tp.py)
against petit_kernel_tpu's on the same bytes, on the CPU.

The port's ranks are spawned processes (tests/_torch_parallel_ranks.py:
gloo over a file store, "cpu" DeviceMeshes), one group of 2 ranks and one
of 4, each started once for the whole file and running every case of its
world size; the tests read their results. The JAX package runs on this
process's 8 virtual CPU devices, over Meshes of the same shapes, and its
quantized trees are carried to the ranks by convert.params_from_jax and
sliced by the rank rule (convert.params_tp_from_jax, checked here).

Tolerances: the GEMM bound, rtol 2^-7 with atol 2^-8 * max|want|
(tests/test_torch_gemm.py), where one GEMM is held against another:
the reduce-scatter GEMM against the JAX one and against the all_reduce
path. Logits, whether against the JAX package, against the port's TP
forward (the SP forward) or against the unsharded forward (the sharded
dense one), within 2^-5 * max|want|, the Llama forward's bound
(tests/test_torch_llama.py): the GEMM bound does not hold there even at
one rank, where the port's unsharded forward and the JAX TP forward on the
same bytes differ by 0.0089 * max|want| (this file's config, tokens and
params, no collective involved); and at tp = 4 gloo sums the four ranks'
bf16 partials in other orders in its all-reduce and its reduce-scatter
(the SP forward differs from the TP forward by 0.010 * max|want| there,
bit for bit equal at tp = 2), neither XLA's psum order. Serving streams
follow
tests/test_torch_spec.py's near-tie rule, the JAX TP forward's top-2 gap
taken at the first divergence. Quantized bytes are equal.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_parallel_ranks as ranks
from petit_kernel_tpu import parallel as jpar
from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu.parallel import tp as jtp
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.ops import layout as tlayout
from petit_kernel_tpu_torch.parallel import tp as ttp

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

# tests/test_parallel.py's config: 16 heads and 4 KV heads split 2 and 4
# ways, wo's and w_down's k shards stay >= 128, the kernels' floor
CFG = jllama.LlamaConfig(
    vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
    num_heads=16, num_kv_heads=4, head_dim=32, max_seq_len=64)
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
FORMATS = ("nvfp4", "nvfp4p2", "nvfp4p2z", "mxfp4")
# the TP engines' set-ups, tests/test_serving.py:164 and :584
ENGINE_REQS = {
    "bf16": [(i, np.arange(3 + i) % 50, 6) for i in range(3)],
    "fp8": [(i, np.arange(3 + i) % 50, 5) for i in range(2)],
}


def _jmesh(dp, tp):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("dp", "tp"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return convert.params_from_jax(_np(tree), device="cpu")


def _cfg_fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def tp_setup(tmp_path_factory):
    """JAX params and quantized trees, and the two spawned rank groups,
    started at once so that they run while the JAX references compute."""
    dense = jllama.init_params(CFG, jax.random.PRNGKey(0))
    # one JAX tree a mesh shape (its arrays live on that mesh's devices);
    # the bytes depend on tp alone
    qtp = {m: jpar.quantize_params_tp(dense, CFG, _jmesh(*m))
           for w in MESHES.values() for m in w}
    rng = np.random.default_rng(5)
    w_rs = (rng.standard_normal((512, 256)) / 8).astype(np.float32)
    a_rs = jnp.asarray(rng.standard_normal((8, 512)), jnp.bfloat16)
    rs_layers = {tp: jpar.quantize_linear_tp(w_rs, tp, "k") for tp in (2, 4)}
    tokens = np.random.default_rng(1).integers(
        0, CFG.vocab_size, size=(4, 8)).astype(np.int32)
    ecfg = jllama.LlamaConfig.tiny()
    edense = jllama.init_params(ecfg, jax.random.PRNGKey(0))
    eq = jpar.quantize_params_tp(edense, ecfg, _jmesh(1, 2))
    inputs = {
        "cfg": _cfg_fields(CFG), "meshes": MESHES,
        "tp_params": {tp: _torch(qtp[1, tp]) for tp in (2, 4)},
        "dense": _torch(dense), "tokens": torch.from_numpy(tokens),
        "rs_a": _torch(a_rs),
        "rs_layers": {tp: _torch(q) for tp, q in rs_layers.items()},
        "engine": {"cfg": _cfg_fields(ecfg), "params": _torch(eq),
                   **{f"reqs {k}": v for k, v in ENGINE_REQS.items()}},
    }
    runs = {w: ranks.start("tp", w, inputs,
                           str(tmp_path_factory.mktemp(f"tp{w}")))
            for w in MESHES}
    yield dict(dense=dense, qtp=qtp, tokens=tokens, a_rs=a_rs,
               rs_layers=rs_layers, ecfg=ecfg, eq=eq, runs=runs)
    for run in runs.values():
        ranks.finish(run)


def _results(setup, world):
    return ranks.finish(setup["runs"][world])


def _same_on_every_rank(results, key):
    """Each rank's result of `key` as float numpy; all equal bytes."""
    first = results[0][key]
    for r in results[1:]:
        assert torch.equal(r[key].view(torch.int16),
                           first.view(torch.int16)), key
    return first.float().numpy()


def _close(got, want, what):
    """The GEMM bound."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max(),
                               err_msg=what)


def _logits_close(got, want, what):
    """The Llama forward's bound."""
    want = np.asarray(want, np.float32)
    bound = 2 ** -5 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


# ---------------------------------------------------------------------------
# (a) quantize_linear_tp
# ---------------------------------------------------------------------------

# dequantization error bound of a shard, as a share of its largest |w|:
# one scale step (tests/test_parallel.py:46), except for the pow2 formats
# under k-sharding, whose shared global scale amax / (6 * 448) (the JAX
# rule, carried for byte parity) needs a group scale of 448 where the pow2
# scales stop at 2^8: the largest groups saturate at 6 * 256 * gs =
# 0.571 amax, an error of up to 0.43 amax
_DEQUANT_BOUND = {(f, s): 0.45 if f.startswith("nvfp4p2") and s == "k"
                  else 0.25 for f in FORMATS for s in ("n", "k")}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("shard", ["n", "k"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_linear_tp_matches_jax(fmt, shard, tp):
    """The port's quantize_linear_tp gives the JAX function's words, scales
    and gs byte for byte; rank t's local slice is JAX's column or
    packed-row block t and dequantizes to the weight's columns or rows of
    that block; nvfp4p2z shards hold no stored-zero code
    (tests/test_parallel.py:316)."""
    rng = np.random.default_rng(7)
    k, n = 1024, 256
    w = (rng.standard_normal((k, n)) / 8).astype(np.float32)
    w[:32, 3] = 0.0
    want = jpar.quantize_linear_tp(w, tp, shard, fmt)
    got = ttp.quantize_linear_tp(torch.from_numpy(w), tp, shard, fmt)
    jw, js = np.asarray(want["words"]), np.asarray(want["scales"])
    assert got["words"].dtype == torch.int32 and got["gs"].shape == ()
    np.testing.assert_array_equal(got["words"].numpy(), jw.view(np.int32))
    np.testing.assert_array_equal(got["scales"].view(torch.int16).numpy(),
                                  js.view(np.int16))
    assert got["gs"].item() == float(want["gs"])
    gs = float(want["gs"])
    for t in range(tp):
        loc = ttp.local_linear_tp(got, tp, shard, t)
        if shard == "n":
            c = n // tp
            cols = slice(t * c, (t + 1) * c)
            np.testing.assert_array_equal(loc["words"].numpy(),
                                          jw[:, cols].view(np.int32))
            deq = tlayout.dequant_from_tpu_layout(loc["words"],
                                                  loc["scales"], c, k)
            full = tlayout.dequant_from_tpu_layout(got["words"],
                                                   got["scales"], n, k)
            assert torch.equal(deq, full[:, cols])
            ref = w[:, cols]
        else:
            ks = k // tp
            rw, rs = jw.shape[0] // tp, js.shape[0] // tp
            np.testing.assert_array_equal(
                loc["words"].numpy(), jw[t * rw:(t + 1) * rw].view(np.int32))
            np.testing.assert_array_equal(
                loc["scales"].view(torch.int16).numpy(),
                js[t * rs:(t + 1) * rs].view(np.int16))
            assert loc["words"].shape[0] * 8 == tlayout.padded_k(
                ks, tlayout.pad_multiple(32 if fmt == "mxfp4" else 16))
            deq = tlayout.dequant_from_tpu_layout(loc["words"],
                                                  loc["scales"], n, ks)
            ref = w[t * ks:(t + 1) * ks]
            if fmt == "nvfp4p2z":
                nib = tlayout.unpack_fp4_weights(loc["words"], n, ks)
                assert not ((nib == 0) | (nib == 8)).any()
        err = np.abs(deq.numpy() * gs - ref).max()
        assert err <= np.abs(ref).max() * _DEQUANT_BOUND[fmt, shard], (t, err)


@pytest.mark.parametrize("bad", [("mxfp4z", "k"), ("mxfp4z", "n"),
                                 ("nvfp4", "m")])
def test_quantize_linear_tp_rejects(bad):
    """Formats outside the four, and shards other than "n" and "k", raise
    ValueError (the JAX package's KeyError for mxfp4z is not carried)."""
    fmt, shard = bad
    w = torch.zeros((256, 64))
    with pytest.raises(ValueError, match="nvfp4p2z|shard"):
        ttp.quantize_linear_tp(w, 2, shard, fmt)


# ---------------------------------------------------------------------------
# (b) make_tp_forward, (c) the SP forward, (e) the dense TP forward
# ---------------------------------------------------------------------------

_ALL_MESHES = [m for w in MESHES.values() for m in w]


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tp_forward_matches_jax(tp_setup, mesh):
    """make_tp_forward over the carried params against the JAX
    make_tp_forward on a mesh of the same shape: every rank returns the
    same logits, within the tolerance of the JAX ones."""
    dp, tp = mesh
    want = jtp.make_tp_forward(CFG, _jmesh(dp, tp))(
        tp_setup["qtp"][mesh], jnp.asarray(tp_setup["tokens"]))
    got = _same_on_every_rank(_results(tp_setup, dp * tp),
                              f"fwd {dp}x{tp}")
    assert got.shape == (4, 8, CFG.vocab_size)
    _logits_close(got, want, f"tp forward {mesh}")


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tp_forward_sp_matches_tp_forward_and_jax(tp_setup, mesh):
    """make_tp_forward_sp (token-sharded residual stream, all-gathers and
    reduce-scatters over tokens) against the port's make_tp_forward and
    against the JAX make_tp_forward_sp."""
    dp, tp = mesh
    res = _results(tp_setup, dp * tp)
    got = _same_on_every_rank(res, f"sp {dp}x{tp}")
    _logits_close(got, _same_on_every_rank(res, f"fwd {dp}x{tp}"),
                  "sp against the port's tp forward")
    want = jtp.make_tp_forward_sp(CFG, _jmesh(dp, tp))(
        tp_setup["qtp"][mesh], jnp.asarray(tp_setup["tokens"]))
    _logits_close(got, want, f"sp forward {mesh}")


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_dense_tp_forward_matches_unsharded(tp_setup, mesh):
    """shard_dense_params and the dense bf16 TP forward against the port's
    unsharded llama.forward over the same dense weights."""
    dp, tp = mesh
    got = _same_on_every_rank(_results(tp_setup, dp * tp),
                              f"dense {dp}x{tp}")
    params = _torch(tp_setup["dense"])
    want, _ = tllama.forward(params, torch.from_numpy(tp_setup["tokens"]),
                             tllama.LlamaConfig(**_cfg_fields(CFG)))
    _logits_close(got, want.float().numpy(), f"dense tp forward {mesh}")


# ---------------------------------------------------------------------------
# (d) mul_fp4_tp_rs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_mul_fp4_tp_rs_matches_jax_and_all_reduce(tp_setup, tp):
    """Each rank's (m, n/tp) block of the reduce-scatter GEMM against the
    same columns of the JAX mul_fp4_tp_rs and of the port's all_reduce
    epilogue."""
    res = _results(tp_setup, tp)
    want = np.asarray(jtp.mul_fp4_tp_rs(
        tp_setup["a_rs"], tp_setup["rs_layers"][tp], _jmesh(1, tp), 512),
        np.float32)
    c = want.shape[1] // tp
    for t, r in enumerate(res):
        got = r[f"rs 1x{tp}"]
        assert tuple(got.shape) == (8, c) and got.dtype == torch.bfloat16
        _close(got.float().numpy(), want[:, t * c:(t + 1) * c],
               f"rank {t} against JAX")
        _close(got.float().numpy(),
               r[f"rs all_reduce 1x{tp}"].float().numpy(),
               f"rank {t} against the all_reduce path")


# ---------------------------------------------------------------------------
# (i) carrying the JAX tree across, and quantize_params_tp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_params_tp_from_jax_is_the_ranks_quantize_params_tp(tp_setup, tp):
    """convert.params_tp_from_jax of the JAX quantize_params_tp tree gives
    each rank the local tree that the port's quantize_params_tp makes on
    that rank from the same dense weights, bit for bit."""
    jtree = _np(tp_setup["qtp"][1, tp])
    for t, r in enumerate(_results(tp_setup, tp)):
        carried = convert.params_tp_from_jax(jtree, tp, t, device="cpu")
        _assert_same_tree(r[f"qtp 1x{tp}"], carried, f"rank {t}")


def _assert_same_tree(a, b, path):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), path


# ---------------------------------------------------------------------------
# (f) the TP Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tp_engines(tp_setup):
    """The JAX TP Engine's streams at (1, 2) over the same tiny params."""
    ecfg, eq = tp_setup["ecfg"], tp_setup["eq"]
    mesh = _jmesh(1, 2)
    out = {}
    for tag, dtype, batch in (("bf16", jnp.bfloat16, 4),
                              ("fp8", jnp.float8_e4m3fn, 2)):
        eng = jserving.Engine(
            eq, ecfg, max_batch=batch, forward_fn=jtp.make_tp_step(ecfg, mesh),
            cache=jtp.init_cache_tp(ecfg, batch, mesh, dtype=dtype))
        out[tag] = eng.run([jserving.Request(uid=u, tokens=p,
                                             max_new_tokens=n)
                            for u, p, n in ENGINE_REQS[tag]])
    return out


def _tie_rule(got, want, prompts, logits_of):
    """tests/test_torch_spec.py's rule: equal streams, or a first
    divergence where the reference's top-2 logit gap (logits_of(tokens)
    -> last-position logits) is below 2^-5 * max|logits|."""
    assert sorted(got) == sorted(want)
    for uid in sorted(want):
        sj, st = want[uid], got[uid]
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            assert len(st) == len(sj), uid
            continue
        i = diff[0]
        lg = logits_of(np.concatenate([prompts[uid],
                                       np.asarray(sj[:i], np.int32)]))
        top2 = np.sort(lg)[-2:]
        gap = float(top2[1] - top2[0])
        bound = 2 ** -5 * float(np.abs(lg).max())
        assert gap < bound, (f"request {uid} diverges at token {i} with a "
                             f"top-2 gap {gap} >= {bound}")


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("tag", ["bf16", "fp8"])
def test_tp_engine_matches_jax(tp_setup, jax_tp_engines, tag, block):
    """The TP Engine (make_tp_step, init_cache_tp) at (dp, tp) = (1, 2),
    flat bf16 and headed fp8 caches, eager and run(decode_block=4): every
    rank's streams are equal, and meet the near-tie rule against the JAX
    TP Engine's."""
    res = _results(tp_setup, 2)
    got = res[0]["engine"][f"{tag} block {block}"]
    for r in res[1:]:
        assert r["engine"][f"{tag} block {block}"] == got
    ecfg = tp_setup["ecfg"]
    shape, dtype, dev = res[0]["engine"][f"{tag} cache"]
    hkv = ecfg.num_kv_heads // 2
    assert dev == "cpu"
    if tag == "bf16":
        assert shape == (4, ecfg.max_seq_len, hkv, ecfg.head_dim)
        assert dtype == torch.bfloat16
    else:
        assert shape == (2, hkv, ecfg.max_seq_len, ecfg.head_dim)
        assert dtype == torch.float8_e4m3fn
    fwd = jtp.make_tp_forward(ecfg, _jmesh(1, 2))
    prompts = {u: np.asarray(p, np.int32) for u, p, _ in ENGINE_REQS[tag]}

    def logits_of(seq):
        lg = fwd(tp_setup["eq"], jnp.asarray(seq)[None])
        return np.asarray(lg[0, -1], np.float32)

    _tie_rule(got, jax_tp_engines[tag], prompts, logits_of)


# ---------------------------------------------------------------------------
# (j) imports and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["tp", "ep", "pp"])
def test_parallel_modules_import_without_jax(module):
    """petit_kernel_tpu_torch.parallel and each of its modules, and the
    rank code of these tests, import neither jax nor the JAX package."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import petit_kernel_tpu_torch.parallel, "
            f"petit_kernel_tpu_torch.parallel.{module}, "
            "_torch_parallel_ranks; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'petit_kernel_tpu.')) or "
            "m == 'petit_kernel_tpu']; print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _build_tp(cfg, device_type):
    """init_cache_tp on a (dp, tp) = (1, 2) mesh: the rank's cache."""
    mesh = ranks.StandInMesh(device_type, dp=1, tp=2)
    cache = ttp.init_cache_tp(cfg, 2, mesh)
    assert tuple(cache[0][0].shape) == (2, cfg.max_seq_len, 1, cfg.head_dim)
    return cache[0][0]


def _build_pp(cfg, device_type):
    """init_cache_pp and place_params_pp (of CPU params) on a pp = 2 mesh:
    the stage's cache and its stacked layers."""
    from petit_kernel_tpu_torch.parallel import pp as tpp

    mesh = ranks.StandInMesh(device_type, pp=2)
    ck, _ = tpp.init_cache_pp(cfg, 2, mesh)
    assert tuple(ck.shape) == (1, 2, cfg.max_seq_len, cfg.num_kv_heads,
                               cfg.head_dim)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    placed = tpp.place_params_pp(params, mesh)
    assert placed["layers"]["wq"]["w"].device == ck.device
    assert placed["embed"].device == ck.device
    return ck


@pytest.mark.parametrize("entry", ["tp", "pp"])
@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_entry_points_build_on_the_card_unless_cpu_mesh(device_type, entry):
    """init_cache_tp, init_cache_pp and place_params_pp build on the
    mesh's device: a "cpu" mesh on the CPU, a "cuda" mesh on the card,
    which raises here without one."""
    cfg = tllama.LlamaConfig.tiny()
    build = {"tp": _build_tp, "pp": _build_pp}[entry]
    if device_type == "cuda" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(cfg, device_type)
        return
    assert build(cfg, device_type).device.type == device_type
