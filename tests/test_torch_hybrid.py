"""The port's hybrid family against the JAX package's, on the CPU: the
reduced jamba-v0.1-52b (d_model 64, 4 heads of 16 over 2 kv heads, d_in
128 in 8 SSM heads of 16, d_state 16, chunk 8, 4 experts top-2 at
capacity factor 8, vocab 256, float32) at 8 layers (one block group:
Mamba-2 mixers at positions 0-3 and 5-7, attention at 4, an MoE FFN at
the odd positions) and at 16 (two groups), against
`repro.models.transformer` and `repro.launch.serve`: the tree, the
counts, the conversion, `forward`, every decode step's logits and cache
leaves, decode against the teacher-forced forward, greedy tokens, a
prompt that is no multiple of the chunk and the kernels a path calls
(its training: `test_torch_hybrid_train.py`). Then the Mamba-2 block and the MoE FFN at Jamba's
own head shapes (128 heads of 64, state 64, chunk 256; 16 experts
top-2). Parameters are the same numpy draws in both packages, carried
over by `repro_torch.convert`.

Tolerance: rtol = atol = 1e-5 on activations, logits and cache leaves
(as `test_torch_moe.py`); ids, counts, shapes and greedy tokens exactly.
Two places at 1e-4, as `test_torch_ssm.py` holds the SSD block: the SSD
block at Jamba's head shapes (256-term chunk sums), and the 16-layer
model's decode cache leaves, whose float32 rounding (products summed in
another order by the two frameworks) grows through 15 layers to 1.4e-5
of the Mamba-2 state. The bf16 decode step is held one layer at a time
at 2^-5 relative L2 (eight bf16 roundings); see that test.

The reference's decode step runs under `jax.jit` (its eager `lax.scan`
compiles the group body at every call); its greedy tokens come from its
own `greedy_decode` with that step patched in.

Footprint: the JAX reference is called only through `repro.models`,
`repro.configs` and `repro.launch.serve`; full-width parameters exist
only as shapes (the `meta` device and `jax.eval_shape`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch import serve as j_serve
from repro.models import common as j_common
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, reduced
from repro_torch.convert import _to_tensor, transformer_params_from_arrays
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve, steps
from repro_torch.models import common, moe, ssm
from repro_torch.models import transformer as tf

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-5, atol=1e-5)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_LAYER = 2.0 ** -5          # relative L2, one bf16 decode layer
B, S, MAX_NEW = 2, 12, 3         # S = 12 at chunk 8: 2 chunks, 4 padded
MAX_LEN = S + MAX_NEW
DEPTHS = (8, 16)
JAMBA_52B_PARAMS = 51_471_024_128
J_STEP = jax.jit(j_tf.decode_step, static_argnums=1)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _tok(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _np(v)
    return out


def _configs(layers, **moe_change):
    jcfg = j_reduced(j_get_config(ARCH), layers=layers, d_model=64,
                     vocab=256)
    cfg = reduced(get_config(ARCH), layers=layers, d_model=64, vocab=256)
    if moe_change:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_change))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_change))
    return jcfg, cfg


def _draw_params(jcfg, seed):
    """numpy draws in the shapes of the JAX tree: weights N(0, 1/fan_in)
    (the stacked experts' fan-in is their second-to-last axis), the
    tables N(0, 0.02²), norm scales and D 1 + N(0, 0.1²), conv bias
    N(0, 0.1²); A_log and dt_bias put the decays a step near 0.95, so a
    chunk carries into the next."""
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(s.shape)
        if "scale" in name or "'D'" in name:
            out = 1.0 + 0.1 * z
        elif "table" in name:
            out = 0.02 * z
        elif "A_log" in name:
            out = -1.0 + 0.3 * z
        elif "dt_bias" in name:
            out = -2.0 + 0.3 * z
        elif "conv_b" in name:
            out = 0.1 * z
        else:
            out = z / np.sqrt(s.shape[-2])
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _model(layers):
    jcfg, cfg = _configs(layers)
    arrays = _draw_params(jcfg, seed=layers)
    rng = np.random.default_rng(layers + 1)
    return dict(jcfg=jcfg, cfg=cfg, arrays=arrays,
                jparams=jax.tree.map(jnp.asarray, arrays),
                params=transformer_params_from_arrays(arrays, device="cpu"),
                tokens=rng.integers(0, 256, (B, S)).astype(np.int32))


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda n: f"L{n}")
def model(request):
    return _model(request.param)


_GREEDY = {}


def _jax_greedy(model):
    """The reference's greedy tokens, once per depth."""
    L = model["cfg"].num_layers
    if L not in _GREEDY:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_serve.tf, "decode_step", J_STEP)
            _GREEDY[L] = j_serve.greedy_decode(
                model["jparams"], model["jcfg"], model["tokens"], MAX_NEW,
                MAX_LEN)
    return _GREEDY[L]


def _same_fields(cfg, jcfg):
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(got):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name


# ---------------------------------------------------------------------------
# Configs, trees, counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layers", [*DEPTHS, 32])
def test_configs_match_jax_field_for_field(layers):
    """The full config (32 layers) and the reduced ones, field for field,
    and each layer's kind and the group size as the reference's."""
    if layers == 32:
        cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    else:
        jcfg, cfg = _configs(layers)
        assert (cfg.num_layers, cfg.attn_layer_offset) == (layers, 4)
    _same_fields(cfg, jcfg)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    assert kinds == [j_tf.layer_kind(jcfg, i)
                     for i in range(jcfg.num_layers)]
    assert kinds[:8] == [("ssm", "dense"), ("ssm", "moe")] * 2 + \
        [("attn", "dense"), ("ssm", "moe"), ("ssm", "dense"), ("ssm", "moe")]
    assert cfg.block_group_size() == j_tf.block_group_size(jcfg) == 8


def test_reduced_keeps_a_whole_attention_period():
    """The reference's rules: 2 layers grow to one period of 8; the offset
    stays inside the stack."""
    jcfg = j_reduced(j_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    _same_fields(cfg, jcfg)
    assert cfg.num_layers == 8 and cfg.moe.layer_period == 2
    short = dataclasses.replace(get_config(ARCH), attn_layer_period=4,
                                attn_layer_offset=6)
    assert reduced(short, layers=2).attn_layer_offset == 3


@pytest.mark.parametrize("layers", [*DEPTHS, "full16"])
def test_init_tree_and_count_match_jax(layers):
    """The port's tree on the `meta` device against `jax.eval_shape` of the
    reference's, key for key and shape for shape, and the exact count:
    the reduced configs and jamba at full width and 16 of 32 layers
    (`full16`), which is what the card serves. The reference's
    `param_count()` leaves out (B6) ln1 and ln2 in every layer, each
    Mamba-2 layer's gated norm (d_in), conv bias (conv_dim) and dt_bias
    (H), and ln_f; it counts the MoE at the even layers where the MoE
    sits at the odd ones, the same number at an even depth."""
    if layers == "full16":
        cfg = dataclasses.replace(get_config(ARCH), num_layers=16)
        jcfg = dataclasses.replace(j_get_config(ARCH), num_layers=16)
    else:
        jcfg, cfg = _configs(layers)
    params = tf.init_params(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda: j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == \
        jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert sorted(params["blocks"]) == [f"l{j}" for j in range(8)]
    assert "attn" in params["blocks"]["l4"] and \
        "moe" in params["blocks"]["l7"] and "ffn" in params["blocks"]["l0"]
    n = sum(t.numel() for t in jax.tree.leaves(params))
    assert n == cfg.param_count()
    L, d = cfg.num_layers, cfg.d_model
    d_in, H, _, N = ssm.ssm_dims(cfg)
    n_ssm = sum(cfg.layer_kind(i)[0] == "ssm" for i in range(L))
    uncounted = 2 * L * d + n_ssm * (d_in + (d_in + 2 * N) + H) + d
    assert n == jcfg.param_count() + uncounted
    if layers == "full16":
        assert (n, jcfg.param_count()) == (26_003_949_568, 26_003_581_440)
        assert get_config(ARCH).param_count() == JAMBA_52B_PARAMS


def test_active_param_count_matches_jax():
    """Active parameters: the total less (16 - 2) experts of 3·d·f in each
    of the 16 MoE layers, the same skipped count as the reference's."""
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    skipped = 16 * 14 * 3 * 4096 * 14336
    assert cfg.active_param_count() == cfg.param_count() - skipped
    assert jcfg.param_count() - jcfg.active_param_count() == skipped


def test_conversion_round_trip(model):
    """Every leaf of the reference's tree (eight group positions of mixed
    subtrees) converts with its values; the experts go to bfloat16 in
    `compute_params`, the router and the SSM's f32 leaves do not."""
    params = model["params"]
    got, want = _flat(params), _flat(model["arrays"])
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    cp = tf.compute_params(params, dataclasses.replace(model["cfg"],
                                                       dtype="bfloat16"))
    assert cp["blocks"]["l1"]["moe"]["w_up"].dtype == torch.bfloat16
    assert cp["blocks"]["l1"]["moe"]["router"]["w"].dtype == torch.float32
    assert cp["blocks"]["l0"]["ssm"]["A_log"].dtype == torch.float32
    assert cp["blocks"]["l4"]["attn"]["wq"]["w"].dtype == torch.bfloat16


def test_init_cache_matches_jax(model):
    """k/v at the attention position, the SSM state and conv tail at the
    others, each stacked over the groups."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    cache = tf.init_cache(cfg, 3, 20, device="cpu")
    jcache = jax.eval_shape(lambda: j_tf.init_cache(jcfg, 3, 20))
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        cache) == \
        jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jcache)
    assert set(cache["l4"]) == {"k", "v"} and set(cache["l3"]) == \
        {"h", "conv"}
    assert not any(t.any() for t in jax.tree.leaves(cache))


# ---------------------------------------------------------------------------
# The model and the serving path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [S, 16])
def test_forward_matches_jax(model, seq):
    """S = 12 at chunk 8 pads the Mamba-2 layers to 16; S = 16 is two
    whole chunks."""
    toks = np.random.default_rng(seq).integers(0, 256, (B, seq)).astype(
        np.int32)
    got = tf.forward(model["params"], model["cfg"], {"tokens": _tok(toks)})
    want = j_tf.forward(model["jparams"], model["jcfg"],
                        {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, seq, 256)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decode_steps_match_jax(model):
    """The prompt replayed through decode steps, as serving warms its
    cache: each step's logits against the reference's decode step, the
    caches written in place against its returned caches after every
    step, and the last step against the teacher-forced forward."""
    cfg, jcfg, toks = model["cfg"], model["jcfg"], model["tokens"]
    jcache = j_tf.init_cache(jcfg, B, MAX_LEN)
    cache = tf.init_cache(cfg, B, MAX_LEN, device="cpu")
    buffers = {k: id(v) for k, v in _leaf_ids(cache)}
    cache_tol = TOL if cfg.num_layers == 8 else SSD_TOL
    for t in range(S):
        want, jcache = J_STEP(model["jparams"], jcfg, jcache,
                              jnp.asarray(toks[:, t:t + 1]), t)
        got, cache = tf.decode_step(model["params"], cfg, cache,
                                    _tok(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        got_c, want_c = _flat(cache), _flat(jcache)
        assert got_c.keys() == want_c.keys()
        for key in want_c:
            np.testing.assert_allclose(got_c[key], want_c[key], **cache_tol,
                                       err_msg=f"step {t}: {key}")
    assert {k: id(v) for k, v in _leaf_ids(cache)} == buffers
    full = tf.forward(model["params"], cfg, {"tokens": _tok(toks)})
    np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, -1]), **TOL)


def _leaf_ids(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_ids(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_greedy_decode_matches_teacher_forced_forward(model):
    """The serving-path invariant of the reference's own model test
    (`tests/test_models.py:60-81`), over the mixed cache: greedy decode
    from a 4-token prompt, each step's logits against the forward over
    the same tokens."""
    cfg, params = model["cfg"], model["params"]
    T = 10
    toks = [_tok(model["tokens"][:, t]) for t in range(4)]
    cache = tf.init_cache(cfg, B, T, device="cpu")
    outs = []
    for t in range(T):
        out, cache = tf.decode_step(params, cfg, cache, toks[t][:, None], t)
        outs.append(out)
        if t + 1 == len(toks):
            toks.append(out[:, -1].argmax(-1))
    seq = torch.stack(toks[:T], dim=1)
    fwd = tf.forward(params, cfg, {"tokens": seq})
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(fwd), **TOL)


def test_greedy_decode_matches_jax(model):
    got = serve.greedy_decode(model["params"], model["cfg"], model["tokens"],
                              MAX_NEW, MAX_LEN)
    assert got.dtype == np.int32 and got.shape == (B, MAX_NEW)
    np.testing.assert_array_equal(got, _jax_greedy(model))


def _tree_to_torch(tree):
    """Copies (the port writes its cache in place; a JAX array's buffer
    must stay as it is)."""
    return {k: _tree_to_torch(v) if isinstance(v, dict)
            else _to_tensor(v, "cpu") for k, v in tree.items()}


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bfloat16_decode_layers_match_jax(model, monkeypatch):
    """The card's activation dtype through the decode step, in both
    frameworks on the CPU, one layer at a time: the prompt replayed
    through the reference's decode layers, and at every step and layer
    the port's `_decode_layer` on the same bf16 input and the same cache
    (the reference's, carried over), against the reference's output and
    new cache, then the port's final norm and head on the reference's
    last activation against the reference's logits. Within BF16_LAYER
    (relative L2): a layer rounds to bf16 a handful of times, 2^-8 each,
    where the whole step compounds them over every layer of random
    weights (scripts/port_bf16_decode_gap.py). An MoE layer routes on the
    reference's expert ids, each weighted by the port's own probabilities
    (the replay of chip_smoke.py's `_route`), so that a near tie which
    rounding flips tells no more than rounding; the port's free expert
    sets must agree on at least 0.9 of the (token, layer) pairs."""
    cfg = dataclasses.replace(model["cfg"], dtype="bfloat16")
    jcfg = dataclasses.replace(model["jcfg"], dtype="bfloat16")
    jp, p, toks = model["jparams"], model["params"], model["tokens"]
    j_ids, agree = [], []
    j_router, router = j_moe._router, moe._router

    def j_recorded(p_, x, e):
        weights, ids = j_router(p_, x, e)
        j_ids.append(torch.tensor(np.array(ids), dtype=torch.long))
        return weights, ids

    def replayed(p_, x, e):
        ids = j_ids.pop(0)
        free = router(p_, x, e)[1]
        agree.extend((free.sort(-1).values == ids.sort(-1).values)
                     .all(-1).flatten().tolist())
        probs = torch.softmax(x.float() @ p_["router"]["w"].float(), -1)
        weights = probs.gather(-1, ids)
        return weights / weights.sum(-1, keepdim=True).clamp_min(1e-9), ids

    monkeypatch.setattr(j_moe, "_router", j_recorded)
    monkeypatch.setattr(moe, "_router", replayed)
    G = cfg.block_group_size()
    jcache = j_tf.init_cache(jcfg, B, S)
    for t in range(S):
        x = j_common.embed(jp["embed"], jnp.asarray(toks[:, t:t + 1]),
                           jnp.bfloat16)
        new = {f"l{j}": [] for j in range(G)}
        for g in range(cfg.num_layers // G):
            for j in range(G):
                jc = jax.tree.map(lambda a: a[g], jcache[f"l{j}"])
                cache, x_in = _tree_to_torch(jc), _to_tensor(x, "cpu")
                x, jc = j_tf._decode_layer(
                    jax.tree.map(lambda a: a[g], jp["blocks"][f"l{j}"]), x,
                    jcfg, j, jc, t)
                got = tf._decode_layer(tf._layer(p["blocks"][f"l{j}"], g),
                                       x_in, cfg, j, cache, t)
                assert got.dtype == torch.bfloat16
                what = f"step {t}, layer {g * G + j}"
                assert _rel(got, x) < BF16_LAYER, what
                for key in jc:
                    assert _rel(cache[key], jc[key]) < BF16_LAYER, \
                        f"{what}: {key}"
                new[f"l{j}"].append(jc)
        jcache = {k: jax.tree.map(lambda *a: jnp.stack(a), *v)
                  for k, v in new.items()}
        want = j_common.lm_head(jp.get("unembed", jp["embed"]),
                                j_common.rmsnorm(jp["ln_f"], x))
        got = common.lm_head(p.get("unembed", p["embed"]),
                             common.rmsnorm(p["ln_f"], _to_tensor(x, "cpu")))
        assert _rel(got, want) < BF16_LAYER, f"step {t}: logits"
    assert not j_ids and len(agree) == S * B * cfg.num_layers // 2
    assert np.mean(agree) >= 0.9


@pytest.mark.parametrize("max_batch", [1, 2])
def test_serve_requests_matches_jax_tokens(max_batch):
    """Batched serving at the power knob's two settings, 16 layers: each
    request gets the tokens of the reference's greedy decode."""
    m = _model(16)
    reqs = [serve.Request(rid=i, prompt=m["tokens"][i], max_new=MAX_NEW)
            for i in range(B)]
    stats = serve.serve_requests(m["params"], m["cfg"], reqs,
                                 max_batch=max_batch, max_len=MAX_LEN)
    want = _jax_greedy(m)
    for r in reqs:
        assert r.tokens == want[r.rid].tolist()
    assert stats.batch_size_used == max_batch


def test_steps_prefill_and_decode(model):
    """`launch.steps`' prefill and decode steps on the hybrid (the
    decoder module), against the reference's forward."""
    assert steps.model_module(model["cfg"]) is tf
    toks = model["tokens"]
    got = steps.make_prefill_step(model["cfg"])(model["params"],
                                                {"tokens": _tok(toks)})
    want = j_tf.forward(model["jparams"], model["jcfg"],
                        {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    cache = tf.init_cache(model["cfg"], B, MAX_LEN, device="cpu")
    logits, _ = steps.make_decode_step(model["cfg"])(
        model["params"], cache, _tok(toks[:, :1]), 0)
    np.testing.assert_allclose(_np(logits), _np(got[:, :1]), **TOL)


def test_kernel_calls_on_the_serving_path(model, monkeypatch):
    """What chip_smoke.py expects of the card: a forward runs 2L + L_ssm
    + 1 RMSNorms (ln1 and ln2 per layer, the gated norm in each Mamba-2
    layer, ln_f), flash attention once per attention layer and ssd_scan
    once per Mamba-2 layer; a decode step the same RMSNorms and neither
    of the others."""
    calls = dict.fromkeys(("rmsnorm", "flash_attention", "ssd_scan"), 0)
    for mod, name in ((rms_ops, "rmsnorm"), (fa_ops, "flash_attention"),
                      (ssd_ops, "ssd_scan")):
        fn = getattr(mod, name)

        def wrapper(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)
    cfg = model["cfg"]
    L = cfg.num_layers
    n_attn = L // 8
    norms = 2 * L + (L - n_attn) + 1
    tf.forward(model["params"], cfg, {"tokens": _tok(model["tokens"])})
    assert calls == {"rmsnorm": norms, "flash_attention": n_attn,
                     "ssd_scan": L - n_attn}
    calls.update(dict.fromkeys(calls, 0))
    serve.greedy_decode(model["params"], cfg, model["tokens"], MAX_NEW,
                        MAX_LEN)
    assert calls == {"rmsnorm": norms * (1 + S + MAX_NEW - 1),
                     "flash_attention": n_attn, "ssd_scan": L - n_attn}


def test_remat_checkpoints_a_group_and_changes_nothing():
    """Under autograd with `remat`, each 8-layer group runs inside a
    checkpoint: the logits and the gradient of their sum with respect to
    every leaf are bitwise those without."""
    m = _model(16)
    toks = _tok(m["tokens"])
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(m["cfg"], remat=remat)
        live = jax.tree.map(lambda t: t.clone().requires_grad_(),
                            m["params"])
        out = tf.forward(live, cfg, {"tokens": toks})
        leaves = jax.tree.leaves(live)
        grads.append((out.detach(),
                      torch.autograd.grad(out.sum(), leaves)))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The Mamba-2 block and the MoE FFN at Jamba's own shapes
# ---------------------------------------------------------------------------
def test_ssd_chunked_at_jamba_head_shapes():
    """128 heads of P = 64 over one group of N = 64 and chunk 256, two
    chunks carried across and an initial state, against the reference."""
    s = get_config(ARCH).ssm
    H = 2 * 4096 // s.head_dim
    assert (H, s.head_dim, s.d_state, s.n_groups, s.chunk) == \
        (128, 64, 64, 1, 256)
    rng = np.random.default_rng(21)
    Bz, Sz, P, N, Q = 1, 2 * s.chunk, s.head_dim, s.d_state, s.chunk
    xh = rng.normal(size=(Bz, Sz, H, P)).astype(np.float32)
    dt = (0.01 + 0.02 * rng.random((Bz, Sz, H))).astype(np.float32)
    A = -np.exp(rng.normal(-0.5, 0.3, H)).astype(np.float32)
    Bm = rng.normal(size=(Bz, Sz, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(Bz, Sz, 1, N)).astype(np.float32)
    h0 = rng.normal(size=(Bz, H, P, N)).astype(np.float32)
    y, hl = ssm.ssd_chunked(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm), Q,
                            h0=_t(h0))
    jy, jhl = j_ssm.ssd_chunked(*(jnp.asarray(a) for a in
                                  (xh, dt, A, Bm, Cm)), Q,
                                h0=jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), _np(jy), **SSD_TOL)
    np.testing.assert_allclose(_np(hl), _np(jhl), **SSD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_norm_rows_of_jamba_width(dtype):
    """The SSM's gated norm runs over rows of d_in = 8192: the plain
    rmsnorm against the reference's, f32 at 1e-5 and bf16 to one ulp."""
    rng = np.random.default_rng(22)
    x = (1.5 * rng.standard_normal((16, 8192))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(8192)).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = j_common.rmsnorm({"scale": jnp.asarray(scale)},
                            jnp.asarray(x).astype(jd))
    got = common.rmsnorm({"scale": _t(scale)},
                         _t(x).to(common.dtype_of(dtype)))
    tol = TOL if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_at_jamba_routing_shapes(cf):
    """Jamba's MoE layer, 16 experts top-2 and no shared expert at the
    published factor 1.25 (which drops slots) and at 8, at width d 64 and
    expert width 128, over 2 groups of 150 tokens: ids, capacity, drops
    and the output against the reference."""
    e = dataclasses.replace(get_config(ARCH).moe, d_expert_ff=128,
                            capacity_factor=cf)
    je = dataclasses.replace(j_get_config(ARCH).moe, d_expert_ff=128,
                             capacity_factor=cf)
    assert (e.num_experts, e.top_k, e.num_shared) == (16, 2, 0)
    jcfg = dataclasses.replace(_configs(8)[0], moe=je)
    cfg = dataclasses.replace(_configs(8)[1], moe=e)
    arrays = jax.tree.map(
        lambda a: a[0], _draw_params(jcfg, seed=23)["blocks"]["l1"]["moe"])
    jp = jax.tree.map(jnp.asarray, arrays)
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), arrays)
    x = np.random.default_rng(24).standard_normal((2, 150, 64)).astype(
        np.float32)
    want = j_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    got = moe.moe_apply(p, _t(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    xg, _, gs = moe._group(_t(x), moe.GROUP_SIZE)
    _, ids = moe._router(p, xg, e)
    jxg, _, jgs = j_moe._group(jnp.asarray(x), j_moe.GROUP_SIZE)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(j_moe._router(jp, jxg, je)[1]))
    C = moe._capacity(gs, e)
    assert (gs, C) == (jgs, j_moe._capacity(jgs, je))
    dropped = int((moe._positions(ids, 16) >= C).sum())
    assert (dropped > 0) == (cf == 1.25)
