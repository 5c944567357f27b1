"""The kernels under autograd (uvltrack_tpu_torch/ops/autograd.py) against
the JAX package's custom VJPs (uvltrack_tpu/ops/pallas_attention.py).

- Each Function's gradients of every input against jax.vjp of the JAX twin
  the VJP differentiates (clamp=True), from the same inputs and cotangent:
  in fp32 within 1e-5 of each input's largest |gradient|; in bf16 within
  2e-2 of it plus two bf16 steps at that scale (8.2e-3 at most measured:
  the two packages round the softmax at different points, the JAX twin
  normalizing and then rounding the probabilities to bf16, the kernel's
  plain version rounding e = exp(s) and dividing at the end).
- Each Function's gradients against torch.autograd.grad of its plain
  version from the same inputs and cotangent: bitwise equal, since the
  backward is that recompute.
- The fault this slice closes: a kernel launch writes into a tensor of its
  own, with no grad_fn, so before the Functions a model on the kernels gave
  norm1 and qkv no gradient. With `_on_card` monkeypatched true and the
  launching wrappers replaced by detached plain versions (what a launch
  returns), one backward through the model gives every norm1 / qkv / proj /
  mlp parameter the plain path's gradient (within 1e-5 of the largest).
- Kernels #3, #5 and #6 have no VJP: under autograd their entries raise,
  naming the knob (UVLTRACK_PALLAS_MIN_N, TPU.WEIGHT_QUANT). Shown on meta
  tensors, which take the wrappers' card branch without a card.
- Marker `gpu` (skipped without a card): each Function at B=16, N in {321,
  361}, C=768, H=12: the kernel forward against the plain one, and its
  gradients against the plain Function's, bitwise. Run on the card with
  `python -m pytest tests/test_torch_port_autograd.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import ln_mlp as lm
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp

EPS = 1e-6
F32_TOL = 1e-5
BF16_TOL = 2e-2  # relative to each input's largest |gradient|, plus 2 bf16 steps there


def _case(kind, dtype, b=2, n=48, c=64, heads=2, seed=0):
    """(numpy inputs in flax layout, names) of one Function: x or qkv,
    fp32 LN and biases, weights in `dtype`, a key bias with masked keys."""
    rng = np.random.default_rng(seed)
    kb = np.zeros((b, n), np.float32)
    kb[0, -12:] = -1e10
    kb[1, -5:] = -1e10
    g = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    be = (0.1 * rng.standard_normal(c)).astype(np.float32)

    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    def bias(o):
        return (0.02 * rng.standard_normal(o)).astype(np.float32)

    x = rng.standard_normal((b, n, c)).astype(np.float32)
    if kind == "QkvAttention":
        return [2.0 * rng.standard_normal((b, n, 3 * c)).astype(np.float32), kb]
    if kind == "LnQkvAttention":
        return [x, g, be, w(c, 3 * c), bias(3 * c), kb]
    if kind == "LnQkvAttnProj":
        return [x, g, be, w(c, 3 * c), bias(3 * c), w(c, c), bias(c), kb]
    return [x, g, be, w(c, 4 * c), bias(4 * c), w(4 * c, c), bias(c)]  # LnMlp


# per Function: which inputs are weights (flax (in, out) <-> torch (out, in),
# in the compute dtype), the JAX twin, the port's plain version, statics
SPEC = {
    "LnQkvAttention": ((3,), "_xla_ln_qkv_attention", lqa.ln_qkv_attention_plain,
                       dict(heads=2, eps=EPS, clamp=True), (2, EPS)),
    "QkvAttention": ((), "_xla_qkv_attention", lqa.qkv_attention_plain,
                     dict(heads=2, clamp=True), (2,)),
    "LnQkvAttnProj": ((3, 5), "_xla_ln_qkv_attn_proj", lqp.ln_qkv_attn_proj_plain,
                      dict(heads=2, eps=EPS, clamp=True), (2, EPS)),
    "LnMlp": ((3, 5), "_xla_ln_mlp", lm.ln_mlp_plain, dict(eps=EPS), (EPS,)),
}


def _torch_inputs(kind, arrs, dtype):
    weights = SPEC[kind][0]
    out = []
    for i, a in enumerate(arrs):
        t = torch.from_numpy(a.T.copy() if i in weights else a.copy())
        if i in weights or i == 0:
            t = t.to(dtype)  # weights, and x / qkv, in the compute dtype
        out.append(t.requires_grad_(True))
    return out


def _close(got, ref, tol, steps=0.0):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    bound = tol * scale + steps * scale * 2.0 ** -8
    err = float(np.abs(got - ref).max())
    assert err <= bound, (err, bound, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(SPEC))
def test_function_gradients_match_jax_vjp(kind, dtype):
    """Every input's gradient through the Function (its forward the plain
    version on CPU tensors, its own backward) == jax.vjp of the twin."""
    import jax
    import jax.numpy as jnp
    from uvltrack_tpu.ops import pallas_attention as pa

    from uvltrack_tpu_torch.ops import autograd as ag

    weights, twin, _, kw, static = SPEC[kind]
    tdt = getattr(torch, dtype)
    arrs = _case(kind, dtype)
    tin = _torch_inputs(kind, arrs, tdt)
    out = getattr(ag, kind).apply(*tin, *static)
    ct = np.random.default_rng(5).standard_normal(tuple(out.shape)).astype(np.float32)
    out.backward(torch.from_numpy(ct).to(out.dtype))

    jin = [jnp.asarray(a, dtype) if (i in weights or i == 0) else jnp.asarray(a)
           for i, a in enumerate(arrs)]
    jout, vjp = jax.vjp(lambda *a: getattr(pa, twin)(*a, **kw), *jin)
    assert jout.dtype == jnp.dtype(str(out.dtype).split(".")[1])
    jgrads = vjp(jnp.asarray(ct, jout.dtype))
    for i, (t, jg) in enumerate(zip(tin, jgrads)):
        g = t.grad.float().numpy()
        g = g.T if i in weights else g
        if dtype == "float32":
            _close(g, jg, F32_TOL)
        else:
            _close(g, jg, BF16_TOL, steps=2.0)


@pytest.mark.parametrize("kind", list(SPEC))
def test_function_gradients_equal_the_plain_recompute(kind):
    """Same inputs and cotangent: the Function's gradients are bitwise
    torch.autograd.grad of the plain version (the backward is that
    recompute), and its forward saves the inputs only."""
    from uvltrack_tpu_torch.ops import autograd as ag

    _, _, plain, _, static = SPEC[kind]
    tin = _torch_inputs(kind, _case(kind, "bfloat16", seed=3), torch.bfloat16)
    out = getattr(ag, kind).apply(*tin, *static)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == len(tin) and all(s.shape == t.shape for s, t in zip(saved, tin))
    ct = torch.from_numpy(np.random.default_rng(6).standard_normal(tuple(out.shape))
                          .astype(np.float32)).to(out.dtype)
    got = torch.autograd.grad(out, tin, ct)
    leaves = [t.detach().requires_grad_(True) for t in tin]
    ref = torch.autograd.grad(plain(*leaves, *static), leaves, ct)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ----------------------------------------------------------------- the fault
def _detached(fn):
    """What a kernel launch returns: the function's value in a fresh tensor
    with no grad_fn."""
    def launch(*a, **k):
        with torch.no_grad():
            return fn(*a, **k).detach()
    return launch


KNOBS = {  # knob setting -> the launching wrappers the model must call
    "default": ({}, {"ln_qkv", "qkv_attention"}),
    "fused_proj": ({"UVLTRACK_FUSED_PROJ": "1"}, {"ln_qkv", "qkv_attention", "proj_residual"}),
    "fused_mlp": ({"UVLTRACK_FUSED_MLP": "1"}, {"ln_qkv", "qkv_attention", "ln_mlp"}),
    "prefix_off": ({"UVLTRACK_FUSED_PREFIX": "0"}, {"qkv_attention"}),
}


def _model_grads(model, inputs):
    model.zero_grad(set_to_none=True)
    out = model(*inputs)
    loss = sum((out[k].float() ** 2).mean() for k in ("cls_score", "bbox_map", "cont_score",
                                                        "prompts", "logits"))
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_model_on_the_kernels_gets_every_block_gradient(knob, monkeypatch):
    """The fault test: on the kernel path (the card stood in for), a
    backward gives every ViT block parameter its gradient, equal to the
    plain path's; before the autograd Functions, norm1 and qkv got none."""
    from test_torch_port_model import _inputs, make_pair

    _, _, model = make_pair()
    inputs = [torch.from_numpy(np.asarray(a)) for a in _inputs(2)]
    for k in ("UVLTRACK_FUSED_PROJ", "UVLTRACK_FUSED_MLP", "UVLTRACK_FUSED_PREFIX"):
        monkeypatch.delenv(k, raising=False)
    env, wanted = KNOBS[knob]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "16")
    monkeypatch.setattr(tattn, "_BACKEND", "cuda")
    plain = _model_grads(model, inputs)

    calls = {}
    for mod, name in ((lqa, "ln_qkv"), (lqa, "qkv_attention"), (lqp, "proj_residual"),
                      (lm, "ln_mlp")):
        def counted(*a, _fn=_detached(getattr(mod, name)), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    kern = _model_grads(model, inputs)
    assert set(calls) == wanted and all(v == 4 for v in calls.values()), calls
    block = [n for n in kern if ".blocks." in n]
    assert len(block) == 4 * 12
    for n in block:
        assert kern[n] is not None, f"{n}: no gradient on the kernel path"
        _close(kern[n], plain[n], F32_TOL)


# ----------------------------------------------- kernels without a backward
def _meta(shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


@pytest.fixture
def on_card(monkeypatch):
    """The kernel gates open for meta tensors, which take every wrapper's
    card branch (their device is not the CPU) without a card."""
    monkeypatch.setattr(tattn, "_BACKEND", "cuda")
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    for k in ("UVLTRACK_FUSED_PROJ", "UVLTRACK_FUSED_MLP", "UVLTRACK_FUSED_PREFIX",
              "UVLTRACK_PALLAS_MIN_N"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("grad", [True, False])
def test_bert_kernel_raises_under_autograd(grad, on_card, monkeypatch):
    """#3 (BERT's attention): under autograd its entry names
    UVLTRACK_PALLAS_MIN_N; without a gradient it goes on to the launch
    (which meta tensors cannot pass: a ValueError from the device check)."""
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "32")
    q, k, v = (_meta((2, 12, 40, 64), torch.bfloat16, grad) for _ in range(3))
    err = RuntimeError if grad else ValueError
    with pytest.raises(err, match="UVLTRACK_PALLAS_MIN_N" if grad else "CUDA device"):
        tattn.attention_core(q, k, v, None)


@pytest.mark.parametrize("fused_proj", ["0", "1"])
def test_int8_kernels_raise_under_autograd(fused_proj, on_card, monkeypatch):
    """#5 (and #6 under UVLTRACK_FUSED_PROJ=1): int8 weights are
    inference-only, and the entry names TPU.WEIGHT_QUANT."""
    from uvltrack_tpu_torch.ops.quant import QuantizedTensor

    monkeypatch.setenv("UVLTRACK_FUSED_PROJ", fused_proj)
    c = 768
    x = _meta((1, 321, c), torch.bfloat16, True)
    vec = [_meta((c,)) for _ in range(2)]
    wq = QuantizedTensor(_meta((3 * c, c), torch.int8), _meta((3 * c,)), torch.bfloat16)
    wp = QuantizedTensor(_meta((c, c), torch.int8), _meta((c,)), torch.bfloat16)
    with pytest.raises(RuntimeError, match="TPU.WEIGHT_QUANT"):
        tattn.attention_block_core(x, *vec, wq, _meta((3 * c,)), wp, _meta((c,)), 12,
                                   None, compute_dtype=torch.bfloat16)


def test_bf16_kernel_wrappers_refuse_a_direct_call_under_autograd(on_card):
    """A direct launch that autograd would need a gradient through raises
    (the silent fault), naming the Function to call instead; the dispatch
    goes through the Function, which launches with autograd off and so
    reaches the device check."""
    c = 768
    x = _meta((1, 321, c), torch.bfloat16, True)
    args = (_meta((c,)), _meta((c,)), _meta((3 * c, c), torch.bfloat16), _meta((3 * c,)))
    with pytest.raises(RuntimeError, match="LnQkvAttention"):
        lqa.ln_qkv(x, *args)
    with pytest.raises(RuntimeError, match="QkvAttention"):
        lqa.qkv_attention(_meta((1, 321, 3 * c), torch.bfloat16, True), _meta((1, 321)), 12)
    with pytest.raises(ValueError, match="CUDA device"):
        tattn.attention_ln_qkv_core(x, *args, 12, None, compute_dtype=torch.bfloat16)


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(SPEC))
@pytest.mark.parametrize("n,x_dtype", [(321, "bfloat16"), (361, "float32")])
def test_cuda_function_matches_plain(cuda, kind, n, x_dtype):
    """B=16, C=768, H=12: the kernel forward within chip_smoke.py's bf16
    rule (|d| <= 2e-2 + 2e-2 |plain|; fp32-x MLP and projection outputs
    are bf16 too), and every input's gradient bitwise the plain
    Function's (the same recompute on the same tensors)."""
    from uvltrack_tpu_torch.ops import autograd as ag

    c, heads = 768, 12
    arrs = _case(kind, "bfloat16", b=16, n=n, c=c, heads=heads, seed=n)
    static = {"LnQkvAttention": (heads, EPS), "QkvAttention": (heads,),
              "LnQkvAttnProj": (heads, EPS), "LnMlp": (EPS,)}[kind]
    tin = [t.detach().to(cuda) for t in _torch_inputs(kind, arrs, torch.bfloat16)]
    if kind != "QkvAttention":
        tin[0] = tin[0].to(getattr(torch, x_dtype))
    kern_in = [t.clone().requires_grad_(True) for t in tin]
    plain_in = [t.clone().requires_grad_(True) for t in tin]
    out = getattr(ag, kind).apply(*kern_in, *static)
    ref = SPEC[kind][2](*plain_in, *static)
    assert out.dtype == ref.dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    ct = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(1),
                     device=cuda).to(out.dtype)
    got = torch.autograd.grad(out, kern_in, ct)
    want = torch.autograd.grad(ref, plain_in, ct)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
