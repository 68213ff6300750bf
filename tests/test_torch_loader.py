"""Port parity: the HF checkpoint loader of petit_kernel_tpu_torch against
petit_kernel_tpu's on the same safetensors checkpoints (tiny config, CPU).

Each test writes its checkpoint with safetensors.numpy, as
tests/test_loader.py does, loads it with both packages, and holds the
port's params against the JAX loader's after convert.params_from_jax bit
for bit: words, scales, gs, norms, embeddings, dense layers and biases.
The port reads the shards with its own reader (loader.read_safetensors),
held here against safetensors.numpy.load_file for every dtype it reads.
Each package reads the other's repack cache. A forward of the port-loaded
model is held against the JAX-loaded one within test_torch_llama.py's
tolerance, 2^-5 * max|logits|.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import loader as jloader
from petit_kernel_tpu.numerics import reference as jref
from petit_kernel_tpu.ops import layout as jlayout
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import loader as tloader
from petit_kernel_tpu_torch.numerics import reference as tref

st_numpy = pytest.importorskip("safetensors.numpy")

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

CFG = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=32, rope_theta=10000.0,
           rms_norm_eps=1e-5)
_PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_OPROJ = "model.layers.0.self_attn.o_proj"


def _write_dense_ckpt(path, rng, qwen2=False, dtype=ml_dtypes.bfloat16):
    """tests/test_loader.py's checkpoint, its dense tensors in `dtype`."""
    h, f, v = CFG["hidden_size"], CFG["intermediate_size"], CFG["vocab_size"]
    q = CFG["num_attention_heads"] * CFG["head_dim"]
    kv = CFG["num_key_value_heads"] * CFG["head_dim"]
    t = {"model.embed_tokens.weight": rng.standard_normal((v, h)).astype(
            dtype),
         "model.norm.weight": (1 + rng.standard_normal(h) / 8).astype(dtype),
         "lm_head.weight": rng.standard_normal((v, h)).astype(dtype)}
    shapes = {"self_attn.q_proj": (q, h), "self_attn.k_proj": (kv, h),
              "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, q),
              "mlp.gate_proj": (f, h), "mlp.up_proj": (f, h),
              "mlp.down_proj": (h, f)}
    for i in range(CFG["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        t[pre + "input_layernorm.weight"] = (
            1 + rng.standard_normal(h) / 8).astype(dtype)
        t[pre + "post_attention_layernorm.weight"] = (
            1 + rng.standard_normal(h) / 8).astype(dtype)
        for name, (n, k) in shapes.items():
            t[pre + name + ".weight"] = (
                rng.standard_normal((n, k)) / 8).astype(dtype)
        if qwen2:
            for name in ("self_attn.q_proj", "self_attn.k_proj",
                         "self_attn.v_proj"):
                t[pre + name + ".bias"] = (
                    rng.standard_normal(shapes[name][0]) / 50).astype(dtype)
    st_numpy.save_file(t, os.path.join(path, "model.safetensors"))
    cfg_json = dict(CFG)
    if qwen2:
        cfg_json["architectures"] = ["Qwen2ForCausalLM"]
    with open(os.path.join(path, "config.json"), "w") as fp:
        json.dump(cfg_json, fp)


def _put_modelopt(path, rng, prefix=_OPROJ, zero_row=False):
    """Replace `prefix` of the checkpoint by ModelOpt NVFP4 tensors of a
    fresh weight, the scales stored as U8 (safetensors.numpy, which the
    JAX loader reads through, writes F8_E4M3 but does not read it back);
    returns (w, qw, scales, gs, the checkpoint's tensors)."""
    n = k = 128
    w = rng.standard_normal((n, k)).astype(np.float32) / 8
    if zero_row:
        w[5, :32] = 0.0
    qw, scales, gs = jref.quantize_nvfp4(w)
    t = st_numpy.load_file(os.path.join(path, "model.safetensors"))
    del t[prefix + ".weight"]
    t[prefix + ".weight"] = qw
    t[prefix + ".weight_scale"] = scales
    t[prefix + ".weight_scale_2"] = np.asarray(gs, np.float32)
    st_numpy.save_file(t, os.path.join(path, "model.safetensors"))
    return w, qw, scales, gs, t


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
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
        assert tuple(t_tree.shape) == tuple(np.shape(j_tree)), path
        np.testing.assert_array_equal(_bits(t_tree), _bits(j_tree),
                                      err_msg=path)


def _load_both(path, fmt, **kw):
    """(JAX cfg, JAX params as numpy, port cfg, port params), each loaded
    by its own package."""
    jcfg, jp = jloader.load_llama(str(path), fmt=fmt, **kw)
    tcfg, tp = tloader.load_llama(str(path), fmt=fmt, device="cpu", **kw)
    return jcfg, jax.tree.map(np.asarray, jp), tcfg, tp


def _same_params(jp, tp):
    """The port's tree equals the JAX tree carried over by
    convert.params_from_jax, bit for bit."""
    _assert_same_bits(tp, jp)
    _assert_same_bits(convert.params_from_jax(jp, device="cpu"), jp)


@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16, np.float16,
                                   np.float32], ids=["bf16", "f16", "f32"])
def test_load_dense_and_quantize(tmp_path, dtype):
    """tests/test_loader.py:59 in three checkpoint dtypes: nvfp4 and bf16
    loads equal the JAX loader's bit for bit, and, from a bf16 checkpoint,
    the nvfp4 load equals quantizing the bf16 load (f16 and f32 weights are
    quantized before any bf16 rounding)."""
    _write_dense_ckpt(tmp_path, np.random.default_rng(0), dtype=dtype)
    jcfg, jp, tcfg, tp = _load_both(tmp_path, "nvfp4", use_cache=False)
    assert tcfg == tllama.LlamaConfig(**{
        k: getattr(jcfg, k) for k in tllama.LlamaConfig.__dataclass_fields__})
    assert tcfg.hidden_size == 128 and tcfg.num_layers == 2
    _same_params(jp, tp)
    _, jd, _, td = _load_both(tmp_path, "bf16")
    _same_params(jd, td)
    for lp, dl in zip(tp["layers"], td["layers"]):
        for name in _PROJ if dtype is ml_dtypes.bfloat16 else ():
            q = tllama.quantize_linear(dl[name]["w"], "nvfp4")
            assert torch.equal(lp[name]["words"], q["words"]), name
    assert not os.path.exists(tloader._cache_file(str(tmp_path), "nvfp4"))


@pytest.mark.parametrize("fp8_scales", [False, True], ids=["u8", "f8_e4m3"])
def test_load_prequantized_modelopt(tmp_path, fp8_scales):
    """tests/test_loader.py:80: a ModelOpt projection repacks to the same
    bits in both packages and to the quantization of the same dense weight;
    with its scales stored as F8_E4M3 (a published checkpoint's dtype,
    which only the port reads here) the port's load equals the JAX
    loader's of the same bytes stored as U8."""
    rng = np.random.default_rng(1)
    _write_dense_ckpt(tmp_path, rng)
    w, _, scales, _, t = _put_modelopt(tmp_path, rng)
    jcfg, jp = jloader.load_llama(str(tmp_path), fmt="nvfp4",
                                  use_cache=False)
    jp = jax.tree.map(np.asarray, jp)
    if fp8_scales:
        t[_OPROJ + ".weight_scale"] = scales.view(ml_dtypes.float8_e4m3fn)
        st_numpy.save_file(t, os.path.join(tmp_path, "model.safetensors"))
        raw = tloader.read_safetensors(
            os.path.join(tmp_path, "model.safetensors"))
        assert raw[_OPROJ + ".weight_scale"].dtype == torch.float8_e4m3fn
        del raw
    _, tp = tloader.load_llama(str(tmp_path), fmt="nvfp4", use_cache=False,
                               device="cpu")
    _same_params(jp, tp)
    layer = tp["layers"][0]["wo"]
    expect = tllama.quantize_linear(torch.from_numpy(w).T, "nvfp4")
    assert torch.equal(layer["words"], expect["words"])
    assert torch.equal(layer["scales"].view(torch.int16),
                       expect["scales"].view(torch.int16))
    assert float(layer["gs"]) == float(expect["gs"])


def test_tied_embeddings(tmp_path):
    """tests/test_loader.py:110: without lm_head.weight, lm_head is the
    embedding's transpose, as in the JAX loader."""
    _write_dense_ckpt(tmp_path, np.random.default_rng(2))
    t = st_numpy.load_file(os.path.join(tmp_path, "model.safetensors"))
    del t["lm_head.weight"]
    st_numpy.save_file(t, os.path.join(tmp_path, "model.safetensors"))
    _, jp, tcfg, tp = _load_both(tmp_path, "bf16")
    assert tp["lm_head"]["w"].shape == (tcfg.hidden_size, tcfg.vocab_size)
    assert torch.equal(tp["lm_head"]["w"], tp["embed"].T)
    _same_params(jp, tp)


def test_repack_cache_roundtrip(tmp_path):
    """tests/test_loader.py:120: the second load comes from
    petit_tpu_cache/ with the same bits; a cache older than a shard is
    ignored."""
    _write_dense_ckpt(tmp_path, np.random.default_rng(5))
    tcfg, p1 = tloader.load_llama(str(tmp_path), fmt="nvfp4", device="cpu")
    assert os.path.exists(tloader._cache_file(str(tmp_path), "nvfp4"))
    assert tloader._load_repack_cache(str(tmp_path), "nvfp4") is not None
    _, p2 = tloader.load_llama(str(tmp_path), fmt="nvfp4", device="cpu")
    _assert_same_bits(p2, _as_numpy(p1))
    os.utime(os.path.join(tmp_path, "model.safetensors"))
    assert tloader._load_repack_cache(str(tmp_path), "nvfp4") is None


def _as_numpy(tree):
    """A port params tree as numpy leaves of the JAX package's dtypes
    (bf16 through ml_dtypes, words as uint32)."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    t = tree.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_repack_cache_read_by_the_other_package(tmp_path, writer):
    """A repack cache written by one package's loader is read by the
    other's (the second load comes from the cache: the shard is replaced by
    one whose weights differ, with an older mtime) and gives the writer's
    bits."""
    rng = np.random.default_rng(6)
    _write_dense_ckpt(tmp_path, rng)
    _put_modelopt(tmp_path, rng)
    if writer == "jax":
        _, first = jloader.load_llama(str(tmp_path), fmt="nvfp4")
        first = jax.tree.map(np.asarray, first)
    else:
        _, tfirst = tloader.load_llama(str(tmp_path), fmt="nvfp4",
                                       device="cpu")
        first = _as_numpy(tfirst)
    cache = tloader._cache_file(str(tmp_path), "nvfp4")
    assert os.path.exists(cache)
    # new weights under the old mtime: only a load from the cache gives
    # the first load's words
    shard = os.path.join(tmp_path, "model.safetensors")
    st = os.stat(shard)
    _write_dense_ckpt(tmp_path, np.random.default_rng(60))
    os.utime(shard, ns=(st.st_atime_ns, st.st_mtime_ns))
    if writer == "jax":
        _, second = tloader.load_llama(str(tmp_path), fmt="nvfp4",
                                       device="cpu")
    else:
        _, jsecond = jloader.load_llama(str(tmp_path), fmt="nvfp4")
        second = convert.params_from_jax(jax.tree.map(np.asarray, jsecond),
                                         device="cpu")
    for i, (a, b) in enumerate(zip(second["layers"], first["layers"])):
        for name in _PROJ:
            _assert_same_bits(a[name], b[name], f"layers[{i}].{name}")


def test_load_qwen2_bias(tmp_path):
    """tests/test_loader.py:143: config detection sets attn_bias, the q/k/v
    biases land on their layers bit for bit, and the forward runs them."""
    _write_dense_ckpt(tmp_path, np.random.default_rng(3), qwen2=True)
    jcfg, jp, tcfg, tp = _load_both(tmp_path, "nvfp4", use_cache=False)
    assert tcfg.attn_bias and jcfg.attn_bias
    lp = tp["layers"][0]
    assert all("b" in lp[n] for n in ("wq", "wk", "wv"))
    assert "b" not in lp["wo"] and "b" not in lp["w_gate"]
    _same_params(jp, tp)
    lg, _ = tllama.forward(tp, torch.arange(8)[None] % tcfg.vocab_size,
                           tcfg, fmt="nvfp4")
    assert torch.isfinite(lg.float()).all()


@pytest.mark.parametrize("fmt", ["nvfp4p2", "nvfp4p2z"])
def test_load_prequantized_as_pow2(tmp_path, fmt):
    """tests/test_loader.py:167 and :203: fmt "nvfp4p2" ("nvfp4p2z") over
    a ModelOpt projection requantizes it to pow2 scales (and no stored
    zero) as the JAX loader does, bit for bit; the port's
    requantize_nvfp4_pow2 equals the JAX package's on the same bytes."""
    rng = np.random.default_rng(11 if fmt == "nvfp4p2" else 13)
    _write_dense_ckpt(tmp_path, rng)
    _, qw, scales, gs, _ = _put_modelopt(tmp_path, rng,
                                         zero_row=fmt == "nvfp4p2z")
    _, jp, _, tp = _load_both(tmp_path, fmt, use_cache=False)
    _same_params(jp, tp)
    zf = fmt == "nvfp4p2z"
    want = jref.requantize_nvfp4_pow2(qw, scales, gs, zero_free=zf)
    got = tref.requantize_nvfp4_pow2(torch.from_numpy(qw),
                                     torch.from_numpy(scales),
                                     torch.tensor(gs, dtype=torch.float32),
                                     zero_free=zf)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert float(got[2]) == float(want[2])
    np.testing.assert_array_equal(
        tp["layers"][0]["wo"]["words"].numpy().view(np.uint32),
        jlayout.repack_fp4_weights(want[0], 128, 128))
    if zf:
        nibs = np.concatenate([want[0] & 0xF, want[0] >> 4], axis=-1)
        assert not ((nibs == 0) | (nibs == 8)).any()


def test_read_safetensors_against_the_library(tmp_path):
    """The port's reader gives safetensors.numpy.load_file's values for
    each dtype it reads (BF16, F16, F32, U8, I32; a scalar and an empty
    tensor among them), F8_E4M3 (which load_file does not read here) the
    bits written, and raises, naming the dtype, on another."""
    rng = np.random.default_rng(7)
    t = {"bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
         "f16": rng.standard_normal(7).astype(np.float16),
         "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
         "scalar": np.asarray(2.5, np.float32),
         "u8": rng.integers(0, 256, (4, 6)).astype(np.uint8),
         "i32": rng.integers(-2**31, 2**31 - 1, (5,)).astype(np.int32),
         "empty": np.zeros((0, 3), np.float32)}
    f = os.path.join(tmp_path, "x.safetensors")
    st_numpy.save_file(t, f)
    got = tloader.read_safetensors(f)
    want = st_numpy.load_file(f)
    assert set(got) == set(want) == set(t)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(w),
                                      err_msg=name)
    assert got["bf16"].dtype == torch.bfloat16
    f8 = rng.standard_normal((3, 16)).astype(ml_dtypes.float8_e4m3fn)
    f = os.path.join(tmp_path, "f8.safetensors")
    st_numpy.save_file({"f8": f8, "u8": t["u8"]}, f)
    got = tloader.read_safetensors(f)
    assert got["f8"].dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bits(got["f8"]), f8.view(np.uint8))
    np.testing.assert_array_equal(got["u8"].numpy(), t["u8"])
    bad = os.path.join(tmp_path, "y.safetensors")
    st_numpy.save_file({"z": np.zeros(3, np.float64)}, bad)
    with pytest.raises(ValueError, match="F64"):
        tloader.read_safetensors(bad)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tloader._open_all_tensors(str(empty))


def test_port_loaded_forward_matches_jax_loaded(tmp_path):
    """The port-loaded tiny model's logits against the JAX-loaded one's on
    the same tokens, within 2^-5 * max|logits| (bf16, and nvfp4 with a
    ModelOpt projection)."""
    rng = np.random.default_rng(9)
    _write_dense_ckpt(tmp_path, rng)
    toks = np.random.default_rng(1).integers(0, CFG["vocab_size"], (2, 12))
    for fmt in ("bf16", "nvfp4"):
        if fmt == "nvfp4":
            _put_modelopt(tmp_path, rng)
        jcfg, jp, tcfg, tp = _load_both(tmp_path, fmt, use_cache=False)
        want, _ = jllama.forward(jax.tree.map(jnp.asarray, jp),
                                 jnp.asarray(toks), jcfg, fmt=fmt,
                                 interpret=True)
        got, _ = tllama.forward(tp, torch.from_numpy(toks), tcfg, fmt=fmt)
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2 ** -5 * np.abs(want).max(), (fmt, err)


def test_loader_needs_a_device_or_a_card(tmp_path):
    """Without a card and without device=, load_llama raises (the port's
    entry points never fall back to the CPU unasked)."""
    _write_dense_ckpt(tmp_path, np.random.default_rng(4))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloader.load_llama(str(tmp_path), fmt="nvfp4")
