"""Port parity: pipeline parallelism of petit_kernel_tpu_torch
(parallel/pp.py) against petit_kernel_tpu's on the same bytes, on the CPU.

The port's ranks are spawned processes (tests/_torch_parallel_ranks.py:
gloo over a file store, "cpu" DeviceMeshes), one group of 2 ranks and one
of 4, each started once for the whole file and running every case of its
world size: the pipelined forward at (dp, pp) = (1, 2), (1, 4) and (2, 2)
and the pipelined decode at pp = 2 and 4, n_micro 2 and 4, bf16 and nvfp4.
The JAX package runs on this process's 8 virtual CPU devices over Meshes
of the same shapes (its kernels in interpret mode), and its trees are
carried to the ranks by convert.params_from_jax.

Tolerances: the forward against the JAX make_pp_forward within rtol =
atol = 2e-2, the JAX test's own bound (tests/test_parallel.py:240), and
against the port's unsharded llama.forward within 2^-5 * max|logits|, the
Llama forward's bound (tests/test_torch_llama.py). Decoded tokens are
equal to the JAX make_pp_step's and to greedy_decode's, and each stage's
cache bytes equal the matching layers of the port's unsharded cache after
the same steps. Carried trees are equal byte for byte.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_parallel_ranks as ranks
from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.parallel import pp as jpp
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.parallel import pp as tpp

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

# tests/test_parallel.py's PP config
CFG = jllama.LlamaConfig(
    vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=4,
    num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=32)
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
_ALL_MESHES = [m for w in MESHES.values() for m in w]
FMTS = ("bf16", "nvfp4")
N_MICRO = (2, 4)
B, T0, N_NEW = 4, 6, 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return convert.params_from_jax(_np(tree), device="cpu")


def _jmesh(dp, pp):
    return Mesh(np.array(jax.devices()[:dp * pp]).reshape(dp, pp),
                ("dp", "pp"))


@pytest.fixture(scope="module")
def pp_setup(tmp_path_factory):
    """JAX params (bf16 and nvfp4), tokens and prompts, and the two
    spawned rank groups, started at once so that they run while the JAX
    references compute."""
    dense = jllama.init_params(CFG, jax.random.PRNGKey(1))
    params = {"bf16": dense, "nvfp4": jllama.quantize_params(dense,
                                                             "nvfp4")}
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(2), (B, 8), 0,
                                         CFG.vocab_size), np.int32)
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(3), (B, T0), 0,
                                         CFG.vocab_size), np.int32)
    inputs = {
        "cfg": dataclasses.asdict(CFG), "meshes": MESHES,
        "params": {f: _torch(p) for f, p in params.items()},
        "tokens": torch.from_numpy(tokens),
        "prompt": torch.from_numpy(prompt), "n_new": N_NEW,
        "n_micro": list(N_MICRO),
    }
    runs = {w: ranks.start("pp", w, inputs,
                           str(tmp_path_factory.mktemp(f"pp{w}")))
            for w in MESHES}
    yield dict(params=params, tparams=inputs["params"], tokens=tokens,
               prompt=prompt, runs=runs)
    for run in runs.values():
        ranks.finish(run)


def _results(setup, world):
    return ranks.finish(setup["runs"][world])


def _same_on_every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        assert torch.equal(r[key].view(torch.int16),
                           first.view(torch.int16)), key
    return first.float().numpy()


def _mesh_id(m):
    return f"{m[0]}x{m[1]}"


# ---------------------------------------------------------------------------
# make_pp_forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_forwards(pp_setup):
    """The JAX make_pp_forward's logits at each mesh and format."""
    out = {}
    for dp, pp in _ALL_MESHES:
        mesh = _jmesh(dp, pp)
        for fmt in FMTS:
            placed = jpp.place_params_pp(pp_setup["params"][fmt], mesh)
            fwd = jpp.make_pp_forward(CFG, mesh, n_micro=2, fmt=fmt,
                                      interpret=True)
            out[fmt, (dp, pp)] = np.asarray(
                fwd(placed, jnp.asarray(pp_setup["tokens"])), np.float32)
    return out


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("fmt", FMTS)
def test_pp_forward_matches_jax(pp_setup, jax_forwards, fmt, mesh):
    """make_pp_forward (n_micro 2) on every rank of a (dp, pp) mesh gives
    the same logits, within the JAX test's bound of the JAX
    make_pp_forward's on a mesh of the same shape."""
    dp, pp = mesh
    got = _same_on_every_rank(_results(pp_setup, dp * pp),
                              f"fwd {fmt} {dp}x{pp}")
    assert got.shape == (B, 8, CFG.vocab_size)
    np.testing.assert_allclose(got, jax_forwards[fmt, mesh], rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("fmt", FMTS)
def test_pp_forward_matches_unsharded(pp_setup, fmt, mesh):
    """make_pp_forward against the port's unsharded llama.forward over
    the same params, within the Llama forward's bound."""
    dp, pp = mesh
    got = _same_on_every_rank(_results(pp_setup, dp * pp),
                              f"fwd {fmt} {dp}x{pp}")
    want, _ = tllama.forward(pp_setup["tparams"][fmt],
                             torch.from_numpy(pp_setup["tokens"]),
                             tllama.LlamaConfig(**dataclasses.asdict(CFG)),
                             fmt=fmt)
    want = want.float().numpy()
    err = np.abs(got - want).max()
    assert err <= 2 ** -5 * np.abs(want).max(), (fmt, mesh, err)


# ---------------------------------------------------------------------------
# make_pp_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_decodes(pp_setup):
    """greedy_decode's tokens, and the JAX make_pp_step's over the prompt
    teacher-forced then N_NEW greedy tokens, at pp 2 and 4 and each
    n_micro (bf16, tests/test_parallel.py:249)."""
    params = pp_setup["params"]["bf16"]
    prompt = jnp.asarray(pp_setup["prompt"])
    out = {"greedy": np.asarray(jllama.greedy_decode(
        params, CFG, prompt, N_NEW, fmt="bf16", interpret=True))}
    for pp in MESHES:
        mesh = Mesh(np.array(jax.devices()[:pp]), ("pp",))
        placed = jpp.place_params_pp(params, mesh)
        for n_micro in N_MICRO:
            step = jpp.make_pp_step(CFG, mesh, n_micro=n_micro, fmt="bf16",
                                    interpret=True)
            cache = jpp.init_cache_pp(CFG, B, mesh)
            for t in range(T0):
                logits, cache = step(placed, cache, prompt[:, t],
                                     jnp.full((B,), t, jnp.int32))
            toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
            for t in range(N_NEW - 1):
                logits, cache = step(placed, cache, toks[-1],
                                     jnp.full((B,), T0 + t, jnp.int32))
                toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
            out[pp, n_micro] = np.stack([np.asarray(t) for t in toks], 1)
    return out


def _decoded(setup, pp, fmt, n_micro):
    """The ranks' decode results; every rank's tokens are the same."""
    res = _results(setup, pp)
    key = f"decode {fmt} {n_micro}"
    toks = res[0][key]["tokens"]
    for r in res[1:]:
        assert torch.equal(r[key]["tokens"], toks)
        assert torch.equal(r[key]["logits"].view(torch.int16),
                           res[0][key]["logits"].view(torch.int16))
    return res, key, toks.numpy()


@pytest.mark.parametrize("n_micro", N_MICRO)
@pytest.mark.parametrize("pp", sorted(MESHES))
def test_pp_decode_matches_jax_and_greedy_decode(pp_setup, jax_decodes, pp,
                                                 n_micro):
    """make_pp_step over init_cache_pp (bf16): the prompt teacher-forced,
    then N_NEW greedy tokens, equal to the JAX make_pp_step's at the same
    pp and n_micro and to the JAX greedy_decode's."""
    _, _, got = _decoded(pp_setup, pp, "bf16", n_micro)
    np.testing.assert_array_equal(got, jax_decodes[pp, n_micro])
    np.testing.assert_array_equal(got, jax_decodes["greedy"])


def _unsharded_cache(setup, fmt, tokens):
    """The port's unsharded cache after the same steps: llama.forward at
    T = 1 over the whole batch, the prompt then tokens[:, :-1]."""
    cfg = tllama.LlamaConfig(**dataclasses.asdict(CFG))
    params = setup["tparams"][fmt]
    cache = tllama.init_cache(cfg, B, device="cpu")
    seq = np.concatenate([setup["prompt"], tokens[:, :-1]], axis=1)
    for t in range(seq.shape[1]):
        tllama.forward(params, torch.from_numpy(seq[:, t:t + 1]), cfg, cache,
                       torch.full((B, 1), t, dtype=torch.int32), fmt=fmt,
                       kv_window=cfg.max_seq_len)
    return cache


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("n_micro", N_MICRO)
@pytest.mark.parametrize("pp", sorted(MESHES))
def test_pp_decode_stage_caches_match_unsharded(pp_setup, pp, n_micro, fmt):
    """Each rank's stage cache, (L/pp, B, S, Hkv, d) K and V, holds the
    bytes of its layers of the port's unsharded cache after the same
    steps, and the tokens are the port's greedy_decode's."""
    res, key, toks = _decoded(pp_setup, pp, fmt, n_micro)
    cfg = tllama.LlamaConfig(**dataclasses.asdict(CFG))
    want = tllama.greedy_decode(pp_setup["tparams"][fmt], cfg,
                                torch.from_numpy(pp_setup["prompt"]), N_NEW,
                                fmt=fmt)
    np.testing.assert_array_equal(toks, want.numpy())
    cache = _unsharded_cache(pp_setup, fmt, toks)
    per = CFG.num_layers // pp
    for r in res:
        s = r["stage"]
        ck, cv = r[key]["cache"]
        assert tuple(ck.shape) == (per, B, CFG.max_seq_len,
                                   CFG.num_kv_heads, CFG.head_dim)
        for i in range(per):
            k, v = cache[s * per + i]
            assert torch.equal(ck[i].view(torch.int16), k.view(torch.int16))
            assert torch.equal(cv[i].view(torch.int16), v.view(torch.int16))


# ---------------------------------------------------------------------------
# carrying the JAX tree across; stack_layers
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("mesh", _ALL_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("fmt", FMTS)
def test_params_pp_from_jax_is_the_ranks_place_params_pp(pp_setup, fmt,
                                                         mesh):
    """convert.params_pp_from_jax of the JAX place_params_pp tree gives
    each rank the tree that the port's place_params_pp makes on that rank
    from the converted plain params, byte for byte (quantized words,
    scales and gs stacked too)."""
    dp, pp = mesh
    jtree = _np(jpp.place_params_pp(pp_setup["params"][fmt],
                                    _jmesh(dp, pp)))
    for r in _results(pp_setup, dp * pp):
        s = r[f"stage {dp}x{pp}"]
        carried = convert.params_pp_from_jax(jtree, pp, s, device="cpu")
        _assert_same_tree(r[f"place {fmt} {dp}x{pp}"], carried,
                          f"stage {s}")
        assert carried["layers"]["wqkv" if fmt == "nvfp4" else "wq"][
            "gs" if fmt == "nvfp4" else "w"].shape[0] == CFG.num_layers // pp


def test_stack_layers_and_layer_of():
    """stack_layers stacks every tensor leaf on a new leading axis and
    keeps an equal non-tensor leaf once; layer_of(stacked, i) gives layer
    i's tensors back as views; a differing non-tensor leaf raises."""
    layers = [{"a": torch.full((2, 3), float(i)), "q": {"gs": torch.tensor(
        float(i)), "meta": "m"}, "l": [torch.arange(4) + i]}
        for i in range(3)]
    st = tpp.stack_layers(layers)
    assert tuple(st["a"].shape) == (3, 2, 3) and st["q"]["meta"] == "m"
    assert tuple(st["q"]["gs"].shape) == (3,)
    for i in range(3):
        lp = tpp.layer_of(st, i)
        assert torch.equal(lp["a"], layers[i]["a"])
        assert lp["q"]["gs"].dim() == 0 and lp["q"]["gs"].item() == i
        assert torch.equal(lp["l"][0], layers[i]["l"][0])
        assert lp["a"].data_ptr() == st["a"][i].data_ptr()
    with pytest.raises(ValueError, match="non-tensor"):
        tpp.stack_layers([{"m": 1}, {"m": 2}])


def test_pp_rejects_uneven_splits():
    """Layers that do not split over pp and a batch that does not split
    into n_micro raise ValueError."""
    mesh = ranks.StandInMesh("cpu", pp=3)
    with pytest.raises(ValueError, match="layers"):
        tpp.init_cache_pp(tllama.LlamaConfig(**dataclasses.asdict(CFG)), 4,
                          mesh)
    with pytest.raises(ValueError, match="microbatches"):
        tpp._check_batch(4, 3)
