"""Port parity: styl3r_tpu_torch RoPE, attention, ViT blocks and the CroCo
stacks vs styl3r_tpu, at tiny widths.

Flax params are initialized, perturbed on every leaf with seeded numpy noise
and carried across with the port's converter. Tolerance 1e-5 in f32 on the
CPU: the same math in another summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.models import croco as jc
from styl3r_tpu.models import vit as jv
from styl3r_tpu.ops.attention import dot_product_attention as j_attention
from styl3r_tpu.ops.rope import apply_rope2d as j_rope
from styl3r_tpu_torch.models import croco as tc
from styl3r_tpu_torch.models import vit as tv
from styl3r_tpu_torch.ops import rope as t_rope_mod
from styl3r_tpu_torch.ops.attention import dot_product_attention as t_attention
from styl3r_tpu_torch.ops.rope import apply_rope2d as t_rope
from styl3r_tpu_torch.utils import convert, trace

TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2)


def perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)

    def go(path, x):
        x = np.asarray(x, np.float32)
        return x + scale * rng.standard_normal(x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(go, params)


def load(module, fill, params):
    """Fill `module` from flax params with one of convert's layout rules."""
    sd = {}
    fill(params, sd, "m")
    module.load_state_dict(
        {k[2:]: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}
    )
    return module.eval()


def _close(a, b, **tol):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **(tol or TOL))


def _grid_pos(b, nh, nw):
    return np.broadcast_to(np.asarray(jv.token_grid_positions(nh, nw))[None], (b, nh * nw, 2))


def test_rope2d():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 9, size=(2, 12, 2)).astype(np.int32)
    _close(t_rope(torch.from_numpy(x), torch.from_numpy(pos)), j_rope(jnp.asarray(x), jnp.asarray(pos)))


def _rope_qk_case(case, rng):
    """(q, qpos, k, kpos) as numpy arrays, and q/k as the torch tensors the
    wrapper gets: "qkv_unbind" strided q/k of an Attention's qkv output;
    "expanded" grid positions with the extra token at (h/p, 0), expanded
    over the batch (stride 0); "cross" nq != nk; "no_qpos"/"no_kpos" a side
    left as it is."""
    b, heads, d = 2, 2, 16
    if case == "qkv_unbind":
        qkv = rng.normal(size=(b, 7, 3 * heads * d)).astype(np.float32)
        q, k, _ = torch.from_numpy(qkv).reshape(b, 7, 3, heads, d).unbind(2)
        pos = rng.integers(0, 9, size=(b, 7, 2)).astype(np.int32)
        return q, pos, k, pos
    nq, nk = (6, 9) if case == "cross" else (7, 7)
    q, k = (torch.from_numpy(rng.normal(size=(b, n, heads, d)).astype(np.float32)) for n in (nq, nk))
    if case == "expanded":
        grid = np.concatenate([np.asarray(jv.token_grid_positions(2, 3)), [[2, 0]]]).astype(np.int32)
        pos = np.broadcast_to(grid[None], (b, 7, 2))
        return q, pos, k, pos
    qpos, kpos = (rng.integers(0, 9, size=(b, n, 2)).astype(np.int32) for n in (nq, nk))
    return q, None if case == "no_qpos" else qpos, k, None if case == "no_kpos" else kpos


@pytest.mark.parametrize("case", ["qkv_unbind", "expanded", "cross", "no_qpos", "no_kpos"])
def test_rope2d_qk_on_the_cpu(case):
    """The q/k wrapper on CPU tensors is apply_rope2d on each side (and
    JAX's apply_rope2d), launches no kernel, and leaves a side without
    positions as it is."""
    q, qpos, k, kpos = _rope_qk_case(case, np.random.default_rng(11))
    if case == "expanded":
        expanded = torch.from_numpy(qpos[:1].copy()).expand(2, -1, -1)
    else:
        expanded = None if qpos is None else torch.from_numpy(qpos)
    kpos_t = expanded if case in ("qkv_unbind", "expanded") else None if kpos is None else torch.from_numpy(kpos)
    before = trace.counters()["rope2d"]
    outs = t_rope_mod.rope2d_qk(q, expanded, k, kpos_t)
    assert trace.counters()["rope2d"] == before
    for out, x, p, p_np in zip(outs, (q, k), (expanded, kpos_t), (qpos, kpos)):
        if p is None:
            assert out is x
            continue
        assert torch.equal(out, t_rope(x, p))
        _close(out, j_rope(jnp.asarray(x.numpy()), jnp.asarray(p_np)))


@pytest.mark.parametrize("bad", ["i64_pos", "head_dim_6"])
def test_rope2d_qk_rejects_what_the_kernel_does_not_take(bad):
    q, qpos, k, kpos = _rope_qk_case("cross", np.random.default_rng(12))
    qpos, kpos = torch.from_numpy(qpos), torch.from_numpy(kpos)
    if bad == "i64_pos":
        kpos = kpos.long()
    else:
        q, k = q[..., :6].contiguous(), k[..., :6].contiguous()
    with pytest.raises(ValueError):
        t_rope_mod.rope2d_qk(q, qpos, k, kpos)


@pytest.mark.parametrize("wants", ["both", "q", "k"])
def test_rope2d_gradient_is_the_inverse_rotation(monkeypatch, wants):
    """The autograd Function around the kernel, with the launch played on
    the CPU by apply_rope2d (the inverse rotation as the negated angle):
    outputs and gradients are autograd's through apply_rope2d, for the
    sides that want a gradient, and one launch each way."""
    def launch(base, inverse, x, pos, y=None, ypos=None):
        trace.count("rope2d")
        sign = -1 if inverse else 1
        return t_rope(x, sign * pos, base), None if y is None else t_rope(y, sign * ypos, base)

    monkeypatch.setattr(t_rope_mod, "_launch", launch)
    rng = np.random.default_rng(13)
    q, qpos, k, kpos = _rope_qk_case("cross", rng)
    qpos, kpos = torch.from_numpy(qpos), torch.from_numpy(kpos)
    q.requires_grad_(wants in ("both", "q"))
    k.requires_grad_(wants in ("both", "k"))
    cot = [torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)) for x in (q, k)]
    leaves = [x for x in (q, k) if x.requires_grad]
    before = trace.counters()["rope2d"]
    def grads(outs):
        return torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)), leaves)

    outs = t_rope_mod._Rope2D.apply(100.0, q, qpos, k, kpos)
    ours = grads(outs)
    assert trace.counters()["rope2d"] == before + 2
    plain_outs = (t_rope(q, qpos), t_rope(k, kpos))
    assert all(torch.equal(a, b) for a, b in zip(outs, plain_outs))
    assert all(torch.equal(a, b) for a, b in zip(ours, grads(plain_outs)))


def test_attention():
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, n, 2, 8)).astype(np.float32) for n in (7, 11, 11))
    _close(
        t_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=0.3),
        j_attention(*(jnp.asarray(a) for a in (q, k, v)), scale=0.3),
    )


def test_block_and_decoder_block():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    y = rng.normal(size=(2, 9, 16)).astype(np.float32)
    xpos = _grid_pos(2, 2, 3)
    ypos = _grid_pos(2, 3, 3)

    jb = jv.Block(16, 2, rope_base=100.0)
    p = perturb(jb.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(xpos)), 3)
    tb = load(tv.Block(16, 2, rope_base=100.0), lambda p_, sd, n: convert._block(p_["params"], sd, n), p)
    with torch.no_grad():
        out = tb(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(xpos)))
    _close(out, jb.apply(p, jnp.asarray(x), jnp.asarray(xpos)))

    jd = jv.DecoderBlock(16, 2, rope_base=100.0)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(xpos), jnp.asarray(ypos))
    p = perturb(jd.init(jax.random.key(1), *args), 4)
    td = load(tv.DecoderBlock(16, 2, rope_base=100.0), lambda p_, sd, n: convert._block(p_["params"], sd, n), p)
    with torch.no_grad():
        out, _ = td(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y, xpos, ypos)))
    _close(out, jd.apply(p, *args)[0])


def test_patch_embed():
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, size=(2, 32, 48, 3)).astype(np.float32)
    je = jv.PatchEmbed(16, 24)
    p = perturb(je.init(jax.random.key(2), jnp.asarray(img)), 6)
    te = load(tv.PatchEmbed(16, 24), lambda p_, sd, n: convert._conv(p_["params"]["proj"], sd, f"{n}.proj"), p)
    with torch.no_grad():
        tok, pos = te(torch.from_numpy(img))
    jtok, jpos = je.apply(p, jnp.asarray(img))
    _close(tok, jtok)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def _backbone_inputs(rng, b=1, v=3, h=32, w=48):
    images = rng.uniform(-1, 1, size=(b, v, h, w, 3)).astype(np.float32)
    intr = rng.normal(size=(b, v, 3, 3)).astype(np.float32)
    return images, intr


def test_multiview_backbone_all_levels():
    """Every level of the 13-level pyramid (dec_depth 12), with 3 views so
    the view-1.. stack sees two-view contexts."""
    rng = np.random.default_rng(7)
    images, intr = _backbone_inputs(rng)
    kw = dict(enc_depth=2, dec_depth=12, **DIMS)
    jm = jc.MultiViewCrocoBackbone(**kw)
    p = perturb(jm.init(jax.random.key(3), jnp.asarray(images), jnp.asarray(intr)), 8)
    tm = load(tc.MultiViewCrocoBackbone(**kw), lambda p_, sd, n: convert._croco(p_["params"], sd, n), p)
    with torch.no_grad():
        feat, pos, levels = tm(torch.from_numpy(images), torch.from_numpy(intr))
    jfeat, jpos, jlevels = jm.apply(p, jnp.asarray(images), jnp.asarray(intr))
    _close(feat, jfeat)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert len(levels) == len(jlevels) == 13
    for a, b in zip(levels, jlevels):
        _close(a, b)


def test_token_stylizer():
    rng = np.random.default_rng(9)
    b, v, nh, nw = 1, 2, 2, 3
    style = rng.uniform(-1, 1, size=(b, 48, 32, 3)).astype(np.float32)
    l = nh * nw + 1  # + the intrinsics token, trimmed by the stylizer
    feat = rng.normal(size=(b, v, l, 32)).astype(np.float32)
    pos = np.concatenate(
        [_grid_pos(b * v, nh, nw), np.broadcast_to(np.asarray([[[nh, 0]]]), (b * v, 1, 2))], axis=1
    ).reshape(b, v, l, 2).astype(np.int32)
    kw = dict(enc_depth=2, dec_depth=4, **DIMS)
    jm = jc.TokenStylizer(**kw)
    args = (jnp.asarray(style), jnp.asarray(feat), jnp.asarray(pos))
    p = perturb(jm.init(jax.random.key(4), *args), 10)
    tm = load(tc.TokenStylizer(**kw), lambda p_, sd, n: convert._croco(p_["params"], sd, n), p)
    with torch.no_grad():
        levels = tm(torch.from_numpy(style), torch.from_numpy(feat), torch.from_numpy(pos))
    jlevels = jm.apply(p, *args)
    assert len(levels) == len(jlevels) == 5
    for a, b_ in zip(levels, jlevels):
        assert a.shape == (b, v, l - 1, a.shape[-1])
        _close(a, b_)


def test_generate_ctx_views():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    np.testing.assert_array_equal(
        tc.generate_ctx_views(torch.from_numpy(x)).numpy(), np.asarray(jc.generate_ctx_views(jnp.asarray(x)))
    )


def test_random_token_mask():
    """CroCo's RandomMask by its properties (jax.random's draws have no
    torch counterpart): round(n * ratio) True entries in each row, from
    ranks that permute 0..n-1; the same mask for the same generator state,
    another for another seed."""
    b, n, ratio = 4, 196, 0.9
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    mask = tv.random_token_mask(g, b, n, ratio)
    assert mask.shape == (b, n) and mask.dtype == torch.bool
    assert mask.sum(1).tolist() == [round(n * ratio)] * b
    g.set_state(state)
    noise = torch.rand(b, n, generator=g)
    ranks = noise.argsort(1).argsort(1)
    assert (ranks.sort(1).values == torch.arange(n)).all()
    assert torch.equal(mask, ranks < round(n * ratio))
    g.set_state(state)
    assert torch.equal(tv.random_token_mask(g, b, n, ratio), mask)
    assert not torch.equal(tv.random_token_mask(torch.Generator().manual_seed(4), b, n, ratio), mask)
    # JAX's mask has the same count a row.
    assert np.asarray(jv.random_token_mask(jax.random.key(0), b, n, ratio)).sum(1).tolist() == [round(n * ratio)] * b
