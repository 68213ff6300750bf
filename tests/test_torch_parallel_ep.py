"""Port parity: expert parallelism of petit_kernel_tpu_torch (parallel/ep.py)
and moe.forward's moe_block_fn hook against petit_kernel_tpu's on the same
bytes, on the CPU.

As in tests/test_torch_parallel.py, the port's ranks are spawned processes
(tests/_torch_parallel_ranks.py, gloo, "cpu" DeviceMeshes of shape
(1, ep)), one group at ep = 2 and one at ep = 4, each started once and
running every case; the JAX package runs on this process's 8 virtual CPU
devices, its grouped kernel in Pallas interpret mode (as
tests/test_parallel.py runs it). Tolerances are tests/test_torch_moe.py's:
the MoE block at rtol 2^-7 with atol 2^-8 * max|want|, logits within
2^-5 * max|want|, routing exactly equal where the router inputs hold no
near-tie; Engine streams follow the near-tie rule of
tests/test_torch_spec.py against the JAX EP Engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_parallel_ranks as ranks
from petit_kernel_tpu.models import moe as jmoe
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu.parallel import ep as jep
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import moe as tmoe
from petit_kernel_tpu_torch.parallel import ep as tep

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

EPS = (2, 4)
CFG = jmoe.MixtralConfig.tiny()          # 4 experts, top-2
TCFG = tmoe.MixtralConfig.tiny()
# tests/test_parallel.py:287's requests
REQS = [(i, np.arange(3 + i) % 50, 5) for i in range(2)]
ROUTER_MARGIN = 2 ** -12                 # tests/test_torch_moe.py's


def _jmesh(ep):
    return Mesh(np.array(jax.devices()[:ep]).reshape(1, ep), ("dp", "ep"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return convert.params_from_jax(_np(tree), device="cpu")


def _block_case():
    """tests/test_parallel.py:181's MoE block: T 16, H 128, F 256, E 8,
    top-2, mxfp4 experts, an f32 router."""
    rng = np.random.default_rng(3)
    T, H, F, E = 16, 128, 256, 8
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    router = jnp.asarray(rng.standard_normal((H, E)) * 0.1, jnp.float32)
    experts = {name: jmoe.quantize_moe_linear(
        rng.standard_normal(shape) / 8, "mxfp4")
        for name, shape in (("w_gate", (E, H, F)), ("w_up", (E, H, F)),
                            ("w_down", (E, F, H)))}
    return jmoe.MoEConfig(num_experts=E, top_k=2, capacity_factor=2.0), \
        x, router, experts


@pytest.fixture(scope="module")
def ep_setup(tmp_path_factory):
    mcfg, x, router, experts = _block_case()
    dense = jmoe.init_params(CFG, jax.random.PRNGKey(0))
    qep = {ep: jep.quantize_params_ep(dense, CFG, _jmesh(ep),
                                      moe_fmt="mxfp4") for ep in EPS}
    tokens = np.random.default_rng(11).integers(
        0, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    inputs = {
        "block": {"moe_cfg": dataclasses.asdict(mcfg), "x": _torch(x),
                  "router": _torch(router), "experts": _torch(experts)},
        "cfg": dataclasses.asdict(CFG), "params": _torch(qep[2]),
        "tokens": torch.from_numpy(tokens), "reqs": REQS,
    }
    runs = {ep: ranks.start("ep", ep, inputs,
                            str(tmp_path_factory.mktemp(f"ep{ep}")))
            for ep in EPS}
    yield dict(mcfg=mcfg, x=x, router=router, experts=experts, dense=dense,
               qep=qep, tokens=tokens, runs=runs)
    for run in runs.values():
        ranks.finish(run)


def _results(setup, ep):
    return ranks.finish(setup["runs"][ep])


def _assert_router_margin(x, router, top_k):
    """No near-tie among the top_k + 1 largest router logits of any token
    (tests/test_torch_moe.py)."""
    logits = x.float() @ router.float()
    top = torch.sort(logits, dim=-1, descending=True).values[:, :top_k + 1]
    gap = (top[:, :-1] - top[:, 1:]).min().item()
    bound = ROUTER_MARGIN * logits.abs().max().item()
    assert gap > bound, f"router near-tie: gap {gap} <= {bound}"


def _check_routing(jseen, tseen, top_k):
    """tests/test_torch_moe.py's check: equal top-k choices at every MoE
    block, the margin asserted on the port's router inputs."""
    assert len(jseen) == len(tseen) > 0
    for (jx, jr), (tx, tr) in zip(jseen, tseen):
        _assert_router_margin(torch.from_numpy(tx), tr, top_k)
        _, jidx = jax.lax.top_k(jnp.asarray(jx) @ jnp.asarray(jr, jnp.float32),
                                top_k)
        _, tidx = tmoe.route(torch.from_numpy(tx), tr, top_k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def _logits_close(got, want, what):
    want = np.asarray(want, np.float32)
    bound = 2 ** -5 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


# ---------------------------------------------------------------------------
# (g) make_moe_mlp_ep and the EP forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ep", EPS)
def test_moe_mlp_ep_matches_jax(ep_setup, ep):
    """The EP block on every rank against the JAX make_moe_mlp_ep on an
    (1, ep) mesh: equal bytes on every rank, within the MoE block's
    tolerance of the JAX output, with equal routing."""
    s = ep_setup
    placed, router = jep.place_experts_ep(s["experts"], s["router"],
                                          _jmesh(ep))
    want = np.asarray(jep.make_moe_mlp_ep(s["mcfg"], _jmesh(ep),
                                          interpret=True)(
        s["x"], router, placed), np.float32)
    res = _results(s, ep)
    got = res[0]["block"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    for r in res[1:]:
        assert torch.equal(r["block"].view(torch.int16),
                           got.view(torch.int16))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max())
    x = _torch(s["x"])
    _check_routing([(np.asarray(s["x"], np.float32), s["router"])],
                   [(x.float().numpy(), _torch(s["router"]))], 2)


def _jax_ep_forward(s, ep):
    """The JAX moe.forward through its EP block over the (1, ep) mesh,
    each block's router input recorded."""
    block = jep.make_moe_mlp_ep(jmoe.MoEConfig(CFG.num_experts, CFG.top_k),
                                _jmesh(ep), interpret=True)
    seen = []

    def spy(x, router_w, ex):
        seen.append((np.asarray(x, np.float32), np.asarray(router_w)))
        return block(x, router_w, ex)

    logits, _ = jmoe.forward(s["qep"][ep], jnp.asarray(s["tokens"]), CFG,
                             interpret=True, moe_block_fn=spy)
    return np.asarray(logits, np.float32), seen


@pytest.mark.parametrize("ep", EPS)
def test_ep_forward_matches_jax(ep_setup, ep):
    """moe.forward through the EP block (moe_block_fn) on every rank
    against the JAX moe.forward through its EP block: equal routing at
    every layer, the same logits on every rank, within the logits
    tolerance of the JAX ones."""
    want, jseen = _jax_ep_forward(ep_setup, ep)
    res = _results(ep_setup, ep)
    got = res[0]["forward"]
    for r in res[1:]:
        assert torch.equal(r["forward"].view(torch.int16),
                           got.view(torch.int16))
    _check_routing(jseen, res[0]["seen"], CFG.top_k)
    _logits_close(got.float().numpy(), want, f"ep {ep} forward")


# ---------------------------------------------------------------------------
# (g) the EP Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ep_engines(ep_setup):
    """The JAX EP Engine's streams (make_ep_step) at each ep."""
    out = {}
    for ep in EPS:
        eng = jserving.Engine(
            ep_setup["qep"][ep], CFG, max_batch=2,
            forward_fn=jep.make_ep_step(CFG, _jmesh(ep), interpret=True))
        out[ep] = eng.run([jserving.Request(uid=u, tokens=p,
                                            max_new_tokens=n)
                           for u, p, n in REQS])
    return out


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("ep", EPS)
def test_ep_engine_matches_jax(ep_setup, jax_ep_engines, ep, block):
    """Engine(forward_fn=make_ep_step) on every rank, eager and
    run(decode_block=4): every rank's streams are equal and meet the
    near-tie rule against the JAX EP Engine's, the gap read from the JAX
    single-device Mixtral forward."""
    res = _results(ep_setup, ep)
    got = res[0][f"engine block {block}"]
    for r in res[1:]:
        assert r[f"engine block {block}"] == got
    want = jax_ep_engines[ep]
    assert sorted(got) == sorted(want)
    quant = jmoe.quantize_params(ep_setup["dense"], CFG, fmt="mxfp4")
    for uid, prompt, _ in REQS:
        sj, st = want[uid], got[uid]
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            assert len(st) == len(sj)
            continue
        i = diff[0]
        seq = np.concatenate([prompt, np.asarray(sj[:i])]).astype(np.int32)
        lg, _ = jmoe.forward(quant, jnp.asarray(seq)[None], CFG,
                             interpret=True)
        lg = np.asarray(lg[0, -1], np.float32)
        top2 = np.sort(lg)[-2:]
        gap, bound = float(top2[1] - top2[0]), 2 ** -5 * np.abs(lg).max()
        assert gap < bound, (uid, i, gap, bound)


# ---------------------------------------------------------------------------
# (h) the moe_block_fn hook, (i) carrying the JAX tree across
# ---------------------------------------------------------------------------

def test_moe_forward_block_hook_matches_jax():
    """moe.forward(..., moe_block_fn=f) calls f once a layer in place of
    moe_mlp: with f = moe_mlp it is bit for bit the forward without the
    hook, and it matches the JAX forward through the JAX hook (routing
    equal, logits within tolerance)."""
    dense = jmoe.init_params(CFG, jax.random.PRNGKey(0))
    quant = jmoe.quantize_params(dense, CFG, fmt="mxfp4")
    tquant = _torch(quant)
    toks = np.random.default_rng(12).integers(
        0, CFG.vocab_size, size=(2, 10)).astype(np.int32)
    mcfg = tmoe.MoEConfig(CFG.num_experts, CFG.top_k)
    jseen, tseen = [], []

    def jspy(x, router_w, ex):
        jseen.append((np.asarray(x, np.float32), np.asarray(router_w)))
        return jmoe.moe_mlp(x, router_w, ex, jmoe.MoEConfig(
            CFG.num_experts, CFG.top_k), fmt="mxfp4", interpret=True)

    def tspy(x, router_w, ex):
        tseen.append((x.float().numpy().copy(), router_w))
        return tmoe.moe_mlp(x, router_w, ex, mcfg)

    want, _ = jmoe.forward(quant, jnp.asarray(toks), CFG, interpret=True,
                           moe_block_fn=jspy)
    got, _ = tmoe.forward(tquant, torch.from_numpy(toks), TCFG,
                          moe_block_fn=tspy)
    plain, _ = tmoe.forward(tquant, torch.from_numpy(toks), TCFG)
    assert len(tseen) == len(jseen) == CFG.num_layers
    assert torch.equal(got.view(torch.int16), plain.view(torch.int16))
    _check_routing(jseen, tseen, CFG.top_k)
    _logits_close(got.float().numpy(), want, "hooked forward")


@pytest.mark.parametrize("ep", EPS)
def test_params_ep_from_jax_gives_each_ranks_experts(ep_setup, ep):
    """convert.params_ep_from_jax of the JAX quantize_params_ep tree gives
    rank r the experts [r E/ep, (r+1) E/ep) of every stack, bit for bit
    what place_experts_ep keeps on that rank, and every other leaf whole;
    the port's quantize_params_ep on the same dense weights gives the same
    local trees."""
    jtree = _np(ep_setup["qep"][ep])
    whole = convert.params_from_jax(jtree, device="cpu")
    tdense = _torch(ep_setup["dense"])
    el = CFG.num_experts // ep
    for r in range(ep):
        mesh = ranks.StandInMesh("cpu", rank=r, dp=1, ep=ep)
        got = convert.params_ep_from_jax(jtree, ep, r, device="cpu")
        mine = tep.quantize_params_ep(
            {**tdense, "layers": iter(tdense["layers"])}, TCFG, mesh)
        for lp, wl, ml in zip(got["layers"], whole["layers"],
                              mine["layers"]):
            placed, router = tep.place_experts_ep(wl["experts"],
                                                  wl["router"], mesh)
            assert router is wl["router"]
            for name, layer in lp["experts"].items():
                for key, t in layer.items():
                    assert t.shape[0] == el
                    assert torch.equal(t, placed[name][key])
                    assert torch.equal(t, ml["experts"][name][key])
                    assert torch.equal(
                        t, wl["experts"][name][key][r * el:(r + 1) * el])
            for name in ("wq", "wk", "wv", "wo"):
                for key in ("words", "scales", "gs"):
                    assert torch.equal(lp[name][key], wl[name][key])
                    assert torch.equal(lp[name][key], ml[name][key])
