"""RoPE of q and k in one call (``ops.rope``, ``kernels/rope.py``).

CPU: the wrapper runs ``layers.rope`` on q and on k, so it equals it bit
for bit and matches the JAX package's ``repro.models.layers.rope`` within
2e-5 plus the drift of a 1-ulp frequency over the position, over the
serving modes' position layouts (decode's ``lengths - 1``,
prefill's expanded ``arange``, extend's ``start + arange``), int32 and
int64 positions, head dims 64 and 128, and q and k as contiguous tensors or
as strided views of a fused QKV projection's output; the meta branch gives
the same shapes, and no head gives empty outputs; a CUDA tensor reaches
the kernel library or raises; a tiny model's prefill, decode and extend
call it once an attention layer, its training forward never.

Card (``-m cuda``, skips without compute capability 9.0): the kernel gives
``layers.rope``'s bits at the benchmark's shapes (B1 S2048 H36 KV4 dh128,
B64 decode, extend from 1,500), at head dim 64 and at positions up to
524,287, in f32 and bf16, and the same bits on a second launch; a tiny
model's serving calls launch it once an attention layer, training never.
JAX is imported inside the CPU tests only, so the card tests run on a
machine that has none.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ATTN_MLP, ATTN_MOE  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)
LAYOUTS = ("decode", "prefill", "extend")


def _positions(rng, layout, B, S, dtype, top=4000):
    """The serving modes' positions: decode (B, 1) at lengths - 1, prefill
    an ``arange`` expanded over the batch (stride 0), extend (B, S) from
    each row's start."""
    if layout == "decode":
        lengths = torch.from_numpy(rng.integers(1, top, B)).to(dtype)
        return (lengths - 1)[:, None]
    if layout == "prefill":
        return torch.arange(S, dtype=dtype).expand(B, S)
    start = torch.from_numpy(rng.integers(0, top - S, B)).to(dtype)
    return start[:, None] + torch.arange(S, dtype=dtype)[None, :]


def _qk(rng, B, S, H, KV, dh, fused, dtype=torch.float32, device="cpu"):
    """q (B,S,H,dh), k (B,S,KV,dh): contiguous, or views of a fused QKV
    output split and reshaped as ``_attention`` does (strides of the whole
    row, no copy)."""
    if fused:
        x = torch.from_numpy(rng.standard_normal(
            (B, S, (H + 2 * KV) * dh)).astype(np.float32))
        x = x.to(device, dtype)
        q, k, _ = torch.split(x, [H * dh, KV * dh, KV * dh], dim=-1)
        q, k = q.reshape(B, S, H, dh), k.reshape(B, S, KV, dh)
        assert not q.is_contiguous() or H + KV == 0
        return q, k
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(device, dtype)
        for s in ((B, S, H, dh), (B, S, KV, dh)))


def _attention_layers(cfg):
    return sum(st.n_layers for st in cfg.stages
               if st.kind in (ATTN_MLP, ATTN_MOE))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dh", [64, 128])
def test_rope_cpu_matches_layers_and_jax(dh, pos_dtype, layout, fused):
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    rng = np.random.default_rng(dh + 7 * LAYOUTS.index(layout))
    B, S, H, KV, theta = 3, 1 if layout == "decode" else 9, 6, 2, 1e6
    q, k = _qk(rng, B, S, H, KV, dh, fused)
    pos = _positions(rng, layout, B, S, pos_dtype)
    got_q, got_k = ops.rope(q, k, pos, theta)
    assert got_q.is_contiguous() and got_k.is_contiguous()
    assert torch.equal(got_q, layers.rope(q, pos, theta))
    assert torch.equal(got_k, layers.rope(k, pos, theta))
    # XLA's exp gives a few of the frequencies 1 ulp (<= 2^-23 relative,
    # each <= 1) off torch's, which moves an angle by up to pos * 2^-23
    # and an output by that times |x1| + |x2|: a bound that grows with
    # the position, on top of F32_TOL
    jpos = jnp.asarray(pos.numpy())
    for got, x in ((got_q, q), (got_k, k)):
        want = np.asarray(jlayers.rope(jnp.asarray(x.contiguous().numpy()),
                                       jpos, theta))
        drift = 2 * float(x.abs().max()) * int(pos.max()) * 2.0 ** -23
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] + drift)
    meta = ops.rope(q.to("meta"), k.to("meta"), pos.to("meta"), theta)
    assert [(t.shape, t.dtype, t.is_contiguous()) for t in meta] == \
        [(t.shape, t.dtype, True) for t in (got_q, got_k)]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_rope_without_heads_or_tokens_launches_nothing(device):
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    for B, S, H, KV in ((2, 5, 0, 0), (0, 5, 4, 2), (2, 0, 4, 2)):
        q, k = _qk(rng, B, S, H, KV, 128, False, device=device)
        pos = torch.zeros((B, S), dtype=torch.int64, device=device)
        got = ops.rope(q, k, pos)
        assert [tuple(t.shape) for t in got] == \
            [(B, S, H, 128), (B, S, KV, 128)]
    assert ops.launch_counts()["rope"] == 0


def test_rope_on_cuda_reaches_the_kernel_library_or_raises(monkeypatch,
                                                           tmp_path):
    """A CUDA tensor goes to the kernel library, never to the plain
    version: with no compiler it raises the build error; a dtype, head dim
    or shape the kernel does not take raises before that."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build
    from repro_torch.kernels import rope as rp

    def no_nvcc():
        raise build.KernelBuildError("nvcc not found")

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(rp, "rope_plain", plain_must_not_run)
    ops.reset_launch_counts()
    with FakeTensorMode():
        q = torch.empty(2, 3, 4, 16, device="cuda")
        k = torch.empty(2, 3, 2, 16, device="cuda")
        pos = torch.zeros(2, 3, dtype=torch.int64, device="cuda")
        with pytest.raises(build.KernelBuildError):
            ops.rope(q, k, pos)
        with pytest.raises(TypeError):
            ops.rope(q.half(), k.half(), pos)
        with pytest.raises(TypeError):
            ops.rope(q, k, pos.float())
        with pytest.raises(ValueError, match="head dim"):
            ops.rope(torch.empty(2, 3, 4, 15, device="cuda"),
                     torch.empty(2, 3, 2, 15, device="cuda"), pos)
        with pytest.raises(ValueError, match="head dim"):
            ops.rope(torch.empty(2, 3, 4, 258, device="cuda"),
                     torch.empty(2, 3, 2, 258, device="cuda"), pos)
        with pytest.raises(ValueError, match="B,S,KV,dh"):
            ops.rope(q, torch.empty(2, 4, 2, 16, device="cuda"), pos)
    assert ops.launch_counts()["rope"] == 0


def _tiny(device, dtype="float32", layers_=3):
    from repro_torch.models import Model
    cfg = get_config("llama3.1-8b-tiny")
    cfg = dataclasses.replace(
        cfg, compute_dtype=dtype, n_layers=layers_,
        stages=(dataclasses.replace(cfg.stages[0], n_layers=layers_),))
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    return cfg, model, params


def _serving_calls(model, params, vocab, device):
    """Prefill, extend and decode of a batch of 2 on a fresh cache; yields
    after each call."""
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, vocab, (2, 8), generator=gen, device=device,
                         dtype=torch.int32)
    model.prefill(params, toks)
    yield "prefill"
    cache = model.init_cache(2, 64, device=device)
    maxp = cache["block_table"].shape[1]
    cache["block_table"] = torch.arange(2 * maxp, dtype=torch.int32,
                                        device=device).reshape(2, maxp)
    _, cache = model.extend(params, cache, toks)
    yield "extend"
    model.decode(params, cache, toks[:, :1])
    yield "decode"


def test_serving_calls_rotate_once_an_attention_layer(monkeypatch):
    """On the CPU: each serving call makes one ``ops.rope`` call an
    attention layer; a training forward makes none."""
    cfg, model, params = _tiny("cpu")
    calls = []
    real = ops.rope

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "rope", counting)
    n = _attention_layers(cfg)
    assert n == 3
    for _ in _serving_calls(model, params, cfg.vocab, "cpu"):
        assert len(calls) == n
        calls.clear()
    toks = torch.randint(0, cfg.vocab, (2, 8))
    model.forward(params, toks)
    assert calls == []


# ---------- the CUDA kernel against layers.rope (card only) ----------

@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: (B, S, H, KV, dh, layout, top position, theta): starcoder2-7b's prefill
#: chunk and 64-row decode, an extend from 1,500, zamba2's dh 64, a
#: sequence-sharded decode's positions near 524,287
CARD_CASES = (
    (1, 2048, 36, 4, 128, "prefill", None, 1e6),
    (64, 1, 36, 4, 128, "decode", 3840, 1e6),
    (4, 256, 36, 4, 128, "extend", 1500, 1e6),
    (8, 256, 32, 32, 64, "extend", 2048, 1e4),
    (8, 1, 32, 8, 128, "decode", 524288, 5e5),
)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,dh,layout,top,theta", CARD_CASES)
def test_rope_kernel_bitwise_matches_plain(sm90, B, S, H, KV, dh, layout,
                                           top, theta, dtype, pos_dtype,
                                           fused):
    rng = np.random.default_rng(B * S + dh)
    q, k = _qk(rng, B, S, H, KV, dh, fused, dtype, sm90)
    if layout == "extend":
        start = torch.from_numpy(rng.integers(top - S, top, B))
        pos = start[:, None] + torch.arange(S)[None, :]
    elif layout == "decode":
        pos = torch.from_numpy(rng.integers(top - 2 * B, top, B))[:, None]
    else:
        pos = torch.arange(S).expand(B, S)
    pos = pos.to(sm90, pos_dtype)
    ops.reset_launch_counts()
    got = ops.rope(q, k, pos, theta)
    again = ops.rope(q, k, pos, theta)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rope"] == 2
    want = (layers.rope(q, pos, theta), layers.rope(k, pos, theta))
    for g, a, w in zip(got, again, want):
        assert g.is_contiguous() and g.dtype == dtype
        assert torch.equal(g, a)
        assert torch.equal(g, w), (g.float() - w.float()).abs().max()


@pytest.mark.cuda
def test_rope_launches_once_an_attention_layer_on_the_card(sm90):
    cfg, model, params = _tiny(sm90, "bfloat16")
    n = _attention_layers(cfg)
    ops.reset_launch_counts()
    for _ in _serving_calls(model, params, cfg.vocab, sm90):
        torch.cuda.synchronize()
        assert ops.launch_counts()["rope"] == n
        ops.reset_launch_counts()
    from torch.utils._pytree import tree_leaves
    for t in tree_leaves(params):
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 8), device=sm90)
    loss, _ = model.loss_fn(params, {"inputs": toks, "labels": toks})
    loss.backward()
    torch.cuda.synchronize()
    assert ops.launch_counts()["rope"] == 0
