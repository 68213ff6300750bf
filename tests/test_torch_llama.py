"""Port parity: the Llama model of petit_kernel_tpu_torch against
petit_kernel_tpu's on the same weights and tokens (tiny config, CPU).

Tolerance for logits: 2^-5 * max|logits|. The two run the same bf16
dataflow, but f32 sums in other orders and other rope/exp implementations
move single bf16 roundings of activations, and those carry through two
layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import paged as tpaged

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    cfg = jllama.LlamaConfig.tiny()
    dense = jllama.init_params(cfg, jax.random.PRNGKey(0))
    quant = jllama.quantize_params(dense, "nvfp4")
    return cfg, dense, quant


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.dtype(f"i{x.element_size()}"))
    x = np.asarray(x)
    return x.view(np.dtype(f"i{x.dtype.itemsize}"))


def _assert_same_bits(t_tree, j_tree, path="params"):
    if isinstance(j_tree, dict):
        assert set(t_tree) == set(j_tree), path
        for k in j_tree:
            _assert_same_bits(t_tree[k], j_tree[k], f"{path}.{k}")
    elif isinstance(j_tree, (list, tuple)):
        assert len(t_tree) == len(j_tree), path
        for i, (a, b) in enumerate(zip(t_tree, j_tree)):
            _assert_same_bits(a, b, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(_bits(t_tree), _bits(j_tree),
                                      err_msg=path)


def test_params_from_jax_is_bit_identical(tiny):
    cfg, dense, quant = tiny
    for tree in (dense, quant):
        t = convert.params_from_jax(_numpy_tree(tree), device="cpu")
        _assert_same_bits(t, _numpy_tree(tree))
    t = convert.params_from_jax(_numpy_tree(quant), device="cpu")
    lp = t["layers"][0]
    assert lp["wqkv"]["words"].dtype == torch.int32
    assert lp["wqkv"]["scales"].dtype == torch.bfloat16
    assert t["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4z"])
def test_quantize_params_matches_jax(tiny, fmt):
    """The port's quantize_params on converted dense weights gives the JAX
    package's quantized tree, bit for bit (fused wqkv / w_gateup)."""
    cfg, dense, _ = tiny
    want = jllama.quantize_params(dense, fmt)
    got = tllama.quantize_params(
        convert.params_from_jax(_numpy_tree(dense), device="cpu"), fmt)
    _assert_same_bits(got, _numpy_tree(want))


def _logits_close(got, want, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    bound = 2 ** -5 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def test_forward_cached_prefill_then_decode_matches_jax(tiny):
    """2 layers: a cached prefill chunk, then 3 decode steps with kv_window,
    through the flash-prefill / decode-attention / kv-append twins and the
    GEMM twin, against the JAX forward (Pallas kernels in interpret mode)."""
    cfg, _, quant = tiny
    tparams = convert.params_from_jax(_numpy_tree(quant), device="cpu")
    B, T = 2, 16
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(3, B)).astype(np.int32)
    jcache = jllama.init_cache(cfg, B)
    tcache = tllama.init_cache(cfg, B, device="cpu")
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    lj, jcache = jllama.forward(quant, jnp.asarray(toks), cfg, jcache,
                                jnp.asarray(pos), kv_window=128)
    lt, tcache = tllama.forward(tparams, torch.from_numpy(toks), cfg, tcache,
                                torch.from_numpy(pos.copy()), kv_window=128)
    _logits_close(lt, lj, "prefill")
    for i, s in enumerate(steps):
        p = np.full((B, 1), T + i, np.int32)
        lj, jcache = jllama.forward(quant, jnp.asarray(s[:, None]), cfg,
                                    jcache, jnp.asarray(p), kv_window=128)
        lt, tcache = tllama.forward(tparams, torch.from_numpy(s[:, None]),
                                    cfg, tcache, torch.from_numpy(p),
                                    kv_window=128)
        _logits_close(lt, lj, f"decode step {i}")


def test_forward_without_cache_matches_jax(tiny):
    """The full-sequence path (masked softmax, no cache), dense weights."""
    cfg, dense, _ = tiny
    tparams = convert.params_from_jax(_numpy_tree(dense), device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(1, 12))
    lj, _ = jllama.forward(dense, jnp.asarray(toks, jnp.int32), cfg)
    lt, _ = tllama.forward(tparams, torch.from_numpy(toks), cfg)
    _logits_close(lt, lj, "no-cache forward")


def test_forward_with_cache_requires_kv_window():
    """A cached forward runs only the kernel path, so it needs kv_window."""
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tllama.init_cache(cfg, 1, device="cpu")
    with pytest.raises(ValueError, match="kv_window"):
        tllama.forward(params, torch.zeros((1, 1), dtype=torch.int64), cfg,
                       cache, torch.zeros((1, 1), dtype=torch.int64))


def test_rope_rotates_interleaved_pairs():
    x = torch.arange(8, dtype=torch.float32).reshape(1, 1, 1, 8)
    pos = torch.tensor([[1]])
    out = tllama.rope(x, pos, 10000.0)
    ang = 1.0 / (10000.0 ** (torch.arange(0, 8, 2).float() / 8))
    x1, x2 = x[..., ::2], x[..., 1::2]
    want0 = x1 * torch.cos(ang) - x2 * torch.sin(ang)
    torch.testing.assert_close(out[..., ::2], want0)


def test_init_params_and_cache_shapes():
    cfg = tllama.LlamaConfig.tiny()
    p = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    assert p["layers"][0]["wq"]["w"].shape == (256, 256)
    assert p["embed"].dtype == torch.bfloat16
    assert p["embed"].device.type == "cpu"      # the generator's device
    cache = tllama.init_cache(cfg, 3, device="cpu")
    assert len(cache) == cfg.num_layers
    assert tuple(cache[0][0].shape) == (3, 128, 2, 64)
    assert cache[0][0].dtype == torch.bfloat16
    assert not tllama.cache_is_headed(cache[0][0], cfg)


_ENTRY_POINTS = {
    "init_cache": lambda cfg: tllama.init_cache(cfg, 1)[0][0],
    "init_paged_cache": lambda cfg: tpaged.init_paged_cache(
        cfg, 1, page_size=64).pages[0][0],
    "params_from_jax": lambda cfg: convert.params_from_jax(
        {"embed": np.zeros((4, 8), np.float32)})["embed"],
    "kv_from_jax": lambda cfg: convert.kv_from_jax(
        [(np.zeros((1, 4), np.float32), np.zeros((1, 4), np.float32))])[0][0],
    "tensor_from_numpy": lambda cfg: convert.tensor_from_numpy(
        np.zeros(3, np.uint32)),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_build_on_the_card_unless_asked(entry):
    """Called without a device, each entry point builds on the CUDA card;
    on a host without one it raises instead of handing back CPU tensors.
    (init_params takes its generator's device: test_init_params_and_cache
    asks for the CPU with a CPU generator.)"""
    cfg = tllama.LlamaConfig.tiny(num_layers=1)
    if torch.cuda.is_available():
        assert _ENTRY_POINTS[entry](cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _ENTRY_POINTS[entry](cfg)
