"""Port parity: the gradient path of petit_kernel_tpu_torch against
petit_kernel_tpu's on the same bytes (CPU): the dequant kernel's twin,
mul_fp4_diff's value and gradients, and a next-token training step of a
tiny quantized Llama.

Tolerances: the dequant twin bit for bit (value times scale is exact);
mul_fp4_diff at the JAX package's own test tolerances
(tests/test_gemm_api.py: value rtol 0.02, da atol 0.02 * max|da|, dgs rtol
0.05); the Llama loss to rel 1e-3 and each gradient within 2^-5 * max|JAX
gradient| (the two forwards round bf16 activations at the same places but
sum in other orders, and the backward carries that through two layers).

The training step is the JAX package's (__graft_entry__.py loss_fn and
train_step): next-token cross-entropy over llama.forward, then
w - 1e-3 * g on the floating leaves. Here the packed words and scales are
frozen (mul_fp4_diff gives them no gradient, and jax.grad refuses the
integer words), and the global scales get their gradient but stay fixed:
a quantized layer's gs is about 1e-4 and its gradient about 1e3, so one
step at 1e-3 would move it by some 10^4 times its value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.ops import gemm as jgemm
from petit_kernel_tpu.ops.kernels import fused as jfused
from petit_kernel_tpu.ops.solution import ElementB as JElementB
from petit_kernel_tpu.utils.testdata import make_gemm_data
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import serving as tserving
from petit_kernel_tpu_torch.ops import gemm as tgemm
from petit_kernel_tpu_torch.ops.kernels import fused as tfused
from petit_kernel_tpu_torch.ops.solution import ElementB

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)


def _torch_operands(d):
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(np.asarray(d.scales_t).view(np.int16)).view(
        torch.bfloat16)
    return words, st


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("k", [512, 384])
@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_dequant_twin_bit_equal_to_jax(fmt, k):
    """k = 384 pads to 512 (nvfp4) or 1024 (mxfp4): the padded rows come
    out as +0.0 in both."""
    n = 128
    d = make_gemm_data(1, n, k, fmt, seed=k)
    eb = JElementB.NVFP4 if fmt == "nvfp4" else JElementB.MXFP4
    want = jfused.dequant_tpu_layout(jnp.asarray(d.words),
                                     jnp.asarray(d.scales_t), element_b=eb,
                                     interpret=True)
    words, st = _torch_operands(d)
    got = tfused.dequant_tpu_layout(
        words, st, element_b=ElementB[fmt.upper()])
    kp = d.words.shape[0] * 8
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (kp, n)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not _bits(got)[k:].any()              # padding: +0.0 exactly


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4z"])
def test_mul_fp4_diff_value_and_grads_match_jax(fmt):
    d = make_gemm_data(8, 128, 512, fmt, seed=3)
    a = jnp.asarray(d.a, jnp.bfloat16)
    b, s = jnp.asarray(d.words), jnp.asarray(d.scales_t)

    def f(a, gs):
        return jnp.sum(jgemm.mul_fp4_diff(fmt, 512, a, b, s, gs)
                       .astype(jnp.float32) ** 2)

    val_j, (da_j, dgs_j) = jax.value_and_grad(f, argnums=(0, 1))(
        a, jnp.float32(d.global_scale))
    words, st = _torch_operands(d)
    at = torch.from_numpy(d.a).to(torch.bfloat16).requires_grad_()
    gst = torch.tensor(d.global_scale, dtype=torch.float32,
                       requires_grad=True)
    y = tgemm.mul_fp4_diff(fmt, 512, at, words, st, gst)
    val_t = (y.float() ** 2).sum()
    val_t.backward()
    assert at.grad.dtype == torch.bfloat16 and gst.grad.shape == ()
    assert np.isclose(val_t.item(), float(val_j), rtol=0.02)
    da_j = np.asarray(da_j, np.float32)
    scale = np.abs(da_j).max()
    np.testing.assert_allclose(at.grad.float().numpy() / scale,
                               da_j / scale, atol=0.02)
    assert np.isclose(gst.grad.item(), float(dgs_j), rtol=0.05)


def test_mul_fp4_diff_without_gradient_is_the_forward():
    """No input requires a gradient: mul_fp4_diff is its mul_* entry."""
    d = make_gemm_data(4, 128, 512, "nvfp4", seed=4)
    words, st = _torch_operands(d)
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    y = tgemm.mul_fp4_diff("nvfp4", 512, a, words, st, d.global_scale)
    want = tgemm.mul_nvfp4_a16(a, words, st, d.global_scale, 4, 128, 512)
    assert y.grad_fn is None
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))


# -- a tiny quantized Llama: loss, gradients and SGD steps -------------------

_FROZEN = ("words", "scales")
_LR = 1e-3
_STEPS = 3


def _trainable(tree, path=""):
    """{path: leaf} of the leaves a step differentiates: every leaf outside
    the frozen words and scales (embed, norms, lm_head, every gs)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k not in _FROZEN:
                out.update(_trainable(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_trainable(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _with(tree, leaves, path=""):
    """tree with the leaves at the paths of `leaves` replaced."""
    if isinstance(tree, dict):
        return {k: _with(v, leaves, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with(v, leaves, f"{path}/{i}") for i, v in enumerate(tree)]
    return leaves.get(path, tree)


def _updated(path: str) -> bool:
    return not path.endswith("/gs")


@pytest.fixture(scope="module")
def trained():
    """3 SGD steps of both packages from the same quantized tiny Llama and
    17-token sequence: (losses, first-step gradients) of each."""
    cfg = jllama.LlamaConfig.tiny(max_seq_len=32)
    jquant = jllama.quantize_params(
        jllama.init_params(cfg, jax.random.PRNGKey(0)), "nvfp4")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(1, 17)).astype(np.int32)

    def jloss(train):
        logits, _ = jllama.forward(_with(jquant, train),
                                   jnp.asarray(toks[:, :-1]), cfg)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(toks[:, 1:, None]), -1)
        return nll.mean()

    vg = jax.jit(jax.value_and_grad(jloss))
    train = _trainable(jquant)
    j_losses, j_grads = [], None
    for _ in range(_STEPS):
        loss, grads = vg(train)
        j_losses.append(float(loss))
        j_grads = j_grads or grads
        train = {p: (w - _LR * grads[p].astype(w.dtype)) if _updated(p)
                 else w for p, w in train.items()}

    tquant = convert.params_from_jax(jax.tree.map(np.asarray, jquant),
                                     device="cpu")
    ttoks = torch.from_numpy(toks).long()
    train_t = {p: w.requires_grad_() for p, w in _trainable(tquant).items()}
    t_losses, t_grads = [], None
    for _ in range(_STEPS):
        logits, _ = tllama.forward(_with(tquant, train_t), ttoks[:, :-1], cfg)
        logp = torch.log_softmax(logits.float(), -1)
        loss = -logp.gather(-1, ttoks[:, 1:, None]).mean()
        loss.backward()
        t_losses.append(loss.item())
        t_grads = t_grads or {p: w.grad for p, w in train_t.items()}
        with torch.no_grad():
            train_t = {p: ((w - _LR * w.grad.to(w.dtype)) if _updated(p)
                           else w.detach()).requires_grad_()
                       for p, w in train_t.items()}
    return dict(cfg=cfg, tparams=tquant, j_losses=j_losses, j_grads=j_grads,
                t_losses=t_losses, t_grads=t_grads)


def test_llama_loss_and_grads_match_jax(trained):
    t, j = trained["t_grads"], trained["j_grads"]
    assert set(t) == set(j)
    assert any(p.endswith("/gs") for p in t)
    np.testing.assert_allclose(trained["t_losses"][0],
                               trained["j_losses"][0], rtol=1e-3)
    for p in sorted(j):
        want = np.asarray(j[p], np.float32)
        got = t[p].float().numpy()
        assert got.shape == want.shape, p
        err = np.abs(got - want).max()
        bound = 2 ** -5 * np.abs(want).max()
        assert np.isfinite(got).all() and err <= bound, (
            f"{p}: max abs err {err} > {bound}")


def test_sgd_steps_match_jax_and_lower_the_loss(trained):
    """Per-step losses of the two packages agree, and fall at every step."""
    jl, tl = trained["j_losses"], trained["t_losses"]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for losses in (jl, tl):
        assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_engine_runs_under_inference_mode(trained):
    """Params that require gradients serve as before: the engine's forward
    builds no graph and leaves no gradient behind."""
    cfg, params = trained["cfg"], trained["tparams"]
    for w in _trainable(params).values():
        w.grad = None
    eng = tserving.Engine(params, cfg, max_batch=2)
    eng.add_request(tserving.Request(uid=0, tokens=np.array(
        [3, 1, 4, 1, 5], np.int32), max_new_tokens=4))
    eng.step()
    logits = eng._decode_logits()
    assert params["embed"].requires_grad
    assert not logits.requires_grad and logits.is_inference()
    out = eng.run([])
    assert len(out[0]) == 4
    assert all(w.grad is None for w in _trainable(params).values())
