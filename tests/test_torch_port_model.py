"""uvltrack_tpu_torch models against the JAX package at the tiny geometry of
tests/test_model.py (C=32, 4 blocks, 4 heads, 32/64 px, 8 text tokens).

The JAX model is initialized, its variables are perturbed from a numpy seed
(so unit norms, zero biases and unit BN stats cannot hide a layout error),
and the same numbers go to the port through models/convert.py. Compared in
fp32 (COMPUTE_DTYPE=float32): tolerance 1e-4 abs and rel; argmax cells must
agree exactly.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_model import NT, TINY, tiny_inputs
from uvltrack_tpu.models.head import MABH as JMABH
from uvltrack_tpu.models.mufe import MUFE as JMUFE
from uvltrack_tpu.models.uvltrack import UVLTrack as JUVLTrack
from uvltrack_tpu_torch.models.bert import BertConfig
from uvltrack_tpu_torch.models.convert import from_jax_variables, load_reference_state
from uvltrack_tpu_torch.models.head import MABH
from uvltrack_tpu_torch.models.mufe import MUFE
from uvltrack_tpu_torch.models.uvltrack import UVLTrack

ATOL = RTOL = 1e-4


def _np_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        else:
            out[k] = (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
    return out


def jax_model(cls_tokenize=False, softmax_one=True, dtype=jnp.float32):
    backbone = JMUFE(**TINY, dtype=dtype)
    head = JMABH(inplanes=32, channel=32, feat_sz=4, cls_tokenize=cls_tokenize,
                 offset_sigmoid=True, joint_cls=False, softmax_one=softmax_one,
                 dtype=dtype)
    return JUVLTrack(backbone=backbone, head=head)


def port_model(cls_tokenize=False, softmax_one=True, dtype=torch.float32):
    b = TINY["bert"]
    bert = BertConfig(vocab_size=b.vocab_size, hidden_size=b.hidden_size,
                      num_layers=b.num_layers, num_heads=b.num_heads,
                      intermediate_size=b.intermediate_size, max_position=b.max_position)
    backbone = MUFE(embed_dim=32, depth=4, num_heads=4, template_size=32, search_size=64,
                    fusion_layers=TINY["fusion_layers"],
                    cont_loss_layers=TINY["cont_loss_layers"],
                    txt_token_mode=TINY["txt_token_mode"], bert=bert, dtype=dtype)
    head = MABH(inplanes=32, channel=32, feat_sz=4, cls_tokenize=cls_tokenize,
                offset_sigmoid=True, joint_cls=False, softmax_one=softmax_one, dtype=dtype)
    return UVLTrack(backbone, head)


@functools.lru_cache(maxsize=None)
def _jax_pair(cls_tokenize, softmax_one, seed):
    """(jax model, perturbed variables as numpy), compiled and made once per
    head configuration and seed."""
    jm = jax_model(cls_tokenize, softmax_one)
    v = _init_fn(cls_tokenize, softmax_one)(jax.random.PRNGKey(seed))
    return jm, _perturb(_np_tree(v), np.random.default_rng(seed))


@functools.lru_cache(maxsize=None)
def _init_fn(cls_tokenize, softmax_one):
    jm, inp = jax_model(cls_tokenize, softmax_one), tiny_inputs()
    return jax.jit(lambda r: jm.init(r, *inp, train=False))


def make_pair(cls_tokenize=False, softmax_one=True, seed=0):
    """(jax model, perturbed jax variables, a new port model holding the same
    weights)."""
    jm, v = _jax_pair(cls_tokenize, softmax_one, seed)
    tm = port_model(cls_tokenize, softmax_one).eval()
    assert load_reference_state(tm, from_jax_variables(v["params"], v["batch_stats"])) == []
    return jm, v, tm


_JITTED = {}


def _backbone(m, *a):
    return m.backbone(*a)


def _cached_text(m, *a):
    return m.backbone.forward_cached_text(*a)


def japply(module, variables, *args, method=None):
    """module.apply under jax.jit, compiled once per module and method: eager
    JAX compiles every op on its first use, which costs far more on the CPU."""
    key = (id(module), method)
    if key not in _JITTED:
        _JITTED[key] = (module, jax.jit(functools.partial(module.apply, method=method)))
    return _JITTED[key][1](variables, *args)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.copy() if a.dtype != np.float32 else a.astype(np.float32))


def _inputs(flag_val, seed=1):
    """tiny_inputs as numpy, with trailing text padding so masks matter."""
    arrs = [np.asarray(a) for a in tiny_inputs(seed=seed, flag_val=flag_val)]
    arrs[3] = np.ones((2, NT), np.int32)
    arrs[3][:, 5:] = 0
    return arrs


def _close(out, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(out.detach().float()), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------- weight bridge
def test_state_dict_keys_follow_the_reference_exporter(pair):
    """from_jax_variables == export_uvltrack key by key and value by value,
    and the port's own state_dict has exactly those keys."""
    from uvltrack_tpu.models.convert import export_uvltrack

    _, v, tm = pair
    ours = from_jax_variables(v["params"], v["batch_stats"])
    ref = export_uvltrack(v["params"], v["batch_stats"])
    assert sorted(ours) == sorted(ref) == sorted(tm.state_dict())
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_load_reference_state_is_strict_and_reports_unused(pair):
    _, v, _ = pair
    state = from_jax_variables(v["params"], v["batch_stats"])
    tm = port_model()
    # old BERT checkpoints name LayerNorm params gamma/beta
    k = "backbone.bert.embeddings.LayerNorm.weight"
    state[k.replace(".weight", ".gamma")] = state.pop(k)
    state["backbone.vit.norm.weight"] = torch.ones(32)
    assert load_reference_state(tm, state) == ["backbone.vit.norm.weight"]
    torch.testing.assert_close(tm.backbone.bert.embeddings.LayerNorm.weight,
                               state[k.replace(".weight", ".gamma")])
    del state["box_head.conv_cls.4.bias"]
    with pytest.raises(ValueError, match="missing"):
        load_reference_state(port_model(), state)


# ------------------------------------------------------------------- blocks
@pytest.mark.parametrize("masked", [False, True])
def test_vit_block_matches_jax(pair, masked):
    from uvltrack_tpu.models.vit import VitBlock as JVitBlock

    _, v, tm = pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 21, 32)).astype(np.float32)
    km = (rng.random((2, 21)) < 0.3) if masked else None
    ref = japply(JVitBlock(32, 4), {"params": v["params"]["backbone"]["block_1"]},
                 jnp.asarray(x), None if km is None else jnp.asarray(km))
    out = tm.backbone.vit.blocks[1](_t(x), None if km is None else torch.from_numpy(km))
    _close(out, ref)


def test_bert_layer_and_embeddings_match_jax(pair):
    from uvltrack_tpu.models.bert import BertEmbeddings as JEmb
    from uvltrack_tpu.models.bert import BertLayer as JLayer
    from uvltrack_tpu.models.bert import bert_attention_bias as jbias
    from uvltrack_tpu_torch.models.bert import bert_attention_bias

    _, v, tm = pair
    bk = v["params"]["backbone"]
    ids = np.random.default_rng(3).integers(0, 100, size=(2, NT)).astype(np.int32)
    mask = np.ones((2, NT), np.int32)
    mask[1, 4:] = 0
    emb = japply(JEmb(TINY["bert"]), {"params": bk["bert_embeddings"]}, jnp.asarray(ids))
    temb = tm.backbone.bert.embeddings(torch.from_numpy(ids))
    _close(temb, emb)
    ref = japply(JLayer(TINY["bert"]), {"params": bk["bert_layer_1"]}, emb,
                 jbias(jnp.asarray(mask)))
    out = tm.backbone.bert.encoder.layer[1](temb, bert_attention_bias(torch.from_numpy(mask)))
    _close(out, ref)


def test_divide_background_matches_jax():
    from uvltrack_tpu.models.head import DistributionPrompter as JP
    from uvltrack_tpu_torch.models.head import DistributionPrompter

    rng = np.random.default_rng(4)
    s = rng.random((3, 1, 20)).astype(np.float32)
    s /= s.sum(-1, keepdims=True)
    # divide_background reads no parameter: call the plain function under
    # flax's method wrapper
    ref = inspect.unwrap(JP.divide_background)(None, jnp.asarray(s))
    out = DistributionPrompter.divide_background(torch.from_numpy(s))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# --------------------------------------------------------------- backbone
def test_encode_text_matches_jax(pair):
    jm, v, tm = pair
    _, _, ids, mask, _, _, _ = _inputs(2)
    ref = japply(jm, v, jnp.asarray(ids), jnp.asarray(mask), method=JUVLTrack.encode_text)
    _close(tm.encode_text(_t(ids), _t(mask)), ref)


@pytest.mark.parametrize("flag_val", [0, 1, 2])
def test_backbone_call_and_cached_text_match_jax(pair, flag_val):
    """MUFE.__call__ (BERT interleaved, per-layer contrastive logits) and
    forward_cached_text, every output of the feature dict."""
    jm, v, tm = pair
    tz, sx, ids, mask, _, _, flag = _inputs(flag_val)
    ref = japply(jm, v, *(jnp.asarray(a) for a in (tz, sx, ids, mask, flag)),
                 method=_backbone)
    out = tm.backbone(_t(tz), _t(sx), _t(ids), _t(mask), _t(flag))
    for key in ("search", "template", "text", "vis_token", "txt_token", "logits"):
        _close(out[key], ref[key])
    txt = tm.encode_text(_t(ids), _t(mask))
    cached = tm.backbone.forward_cached_text(_t(tz), _t(sx), txt, _t(mask), _t(flag))
    jtxt = japply(jm, v, jnp.asarray(ids), jnp.asarray(mask), method=JUVLTrack.encode_text)
    jcached = japply(jm, v, jnp.asarray(tz), jnp.asarray(sx), jtxt, jnp.asarray(mask),
                     jnp.asarray(flag), method=_cached_text)
    for key in ("search", "template", "text", "vis_token", "txt_token"):
        _close(cached[key], jcached[key])


# -------------------------------------------------------------------- head
@pytest.mark.parametrize("cls_tokenize,softmax_one", [(False, True), (True, False)])
@pytest.mark.parametrize("flag_val", [0, 2])
def test_forward_test_paths_match_jax(cls_tokenize, softmax_one, flag_val, pair):
    """MABH test path through forward_test and forward_test_cached: cls map,
    bbox map, contrastive score and the argmax box."""
    jm, v, tm = pair if (cls_tokenize, softmax_one) == (False, True) else make_pair(
        cls_tokenize, softmax_one, seed=5)
    tz, sx, ids, mask, _, _, flag = _inputs(flag_val, seed=6)
    prompt = np.random.default_rng(7).normal(size=(2, 3, 32)).astype(np.float32)
    args = [jnp.asarray(a) for a in (tz, sx, ids, mask, prompt, flag)]
    ref = japply(jm, v, *args, method=JUVLTrack.forward_test)
    out = tm.forward_test(_t(tz), _t(sx), _t(ids), _t(mask), _t(prompt), _t(flag))
    jtxt = japply(jm, v, args[2], args[3], method=JUVLTrack.encode_text)
    ref_c = japply(jm, v, args[0], args[1], jtxt, args[3], args[4], args[5],
                   method=JUVLTrack.forward_test_cached)
    out_c = tm.forward_test_cached(_t(tz), _t(sx), tm.encode_text(_t(ids), _t(mask)),
                                   _t(mask), _t(prompt), _t(flag))
    for o, r in ((out, ref), (out_c, ref_c)):
        for key in ("cls_score_test", "bbox_map", "cont_score", "pred_boxes", "cls_score"):
            _close(o[key], r[key])
        merged = np.asarray(r["cls_score_test"]) * np.asarray(
            jax.nn.softmax(r["cont_score"], axis=-1))[..., 0]
        tmerged = o["cls_score_test"] * torch.softmax(o["cont_score"], -1)[..., 0]
        np.testing.assert_array_equal(tmerged.argmax(-1).numpy(), merged.argmax(-1))


@pytest.mark.parametrize("flag_val", [0, 1, 2])
def test_forward_prompt_init_and_remine_match_jax(pair, flag_val):
    jm, v, tm = pair
    tz, sx, ids, mask, tmask, cmask, flag = _inputs(flag_val, seed=8)
    args = [jnp.asarray(a) for a in (tz, sx, ids, mask, tmask, cmask, flag)]
    ref = japply(jm, v, *args, method=JUVLTrack.forward_prompt_init)
    out = tm.forward_prompt_init(*(_t(a) for a in (tz, sx, ids, mask, tmask, cmask, flag)))
    _close(out, ref)
    feats = japply(jm, v, *args[:4], args[6], method=_backbone)
    feats = {k: feats[k] for k in ("search", "template", "vis_token", "txt_token", "flag")}
    ref_p = japply(jm, v, feats, args[4], args[5], method=JUVLTrack.forward_prompt)
    tfeats = {k: _t(np.asarray(a)) for k, a in feats.items()}
    _close(tm.forward_prompt(tfeats, _t(tmask), _t(cmask)), ref_p)


# ------------------------------------------------------------ dtype policy
def test_inference_cast_matches_jax_policy(pair):
    """>=2-D fp32 parameters go bf16, vectors and scalars stay fp32, as
    cast_inference_variables does to the same tensors."""
    from uvltrack_tpu.models.convert import _uvltrack_rules
    from uvltrack_tpu.models.uvltrack import cast_inference_variables
    from uvltrack_tpu_torch.models.convert import state_key
    from uvltrack_tpu_torch.models.uvltrack import cast_inference_params

    _, v, _ = pair
    jcast = cast_inference_variables({"params": v["params"]})["params"]
    tm = cast_inference_params(make_pair()[2])
    own = dict(tm.named_parameters())
    rules, _ = _uvltrack_rules(v["params"])
    assert len(rules) == len(own)
    for src, dst, _ in rules:
        leaf = jcast
        for k in dst:
            leaf = leaf[k]
        want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 else torch.float32
        assert own[state_key(src)].dtype == want, src


def test_bf16_forward_matches_jax_at_bf16_tolerance():
    """The bf16 rounding points: both models cast for inference and run in
    bf16 from the same weights. One bf16 step is 2^-8 relative; through
    4 blocks and the head the outputs stay within 3e-2."""
    from uvltrack_tpu.models.uvltrack import cast_inference_variables
    from uvltrack_tpu_torch.models.uvltrack import cast_inference_params

    _, v, _ = make_pair(seed=9)
    jm = jax_model(dtype=jnp.bfloat16)
    vb = cast_inference_variables(v)
    tm = port_model(dtype=torch.bfloat16).eval()
    load_reference_state(tm, from_jax_variables(v["params"], v["batch_stats"]))
    cast_inference_params(tm)
    tz, sx, ids, mask, _, _, flag = _inputs(2, seed=10)
    prompt = np.random.default_rng(11).normal(size=(2, 3, 32)).astype(np.float32)
    ref = japply(jm, vb, *(jnp.asarray(a) for a in (tz, sx, ids, mask, prompt, flag)),
                 method=JUVLTrack.forward_test)
    out = tm.forward_test(_t(tz), _t(sx), _t(ids), _t(mask), _t(prompt), _t(flag))
    for key in ("cls_score_test", "bbox_map", "cont_score"):
        _close(out[key], ref[key], atol=3e-2, rtol=3e-2)


# ----------------------------------------------------------- entry points
def test_build_model_refuses_the_cpu_unless_asked(monkeypatch):
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.uvltrack import build_model, init_model

    cfg = load_cfg("experiments/uvltrack/_smoke_cpu.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    m = build_model(cfg, device="cpu", seed=3)
    assert next(m.parameters()).device.type == "cpu"
    # UVLTrack-B at full width: ViT-B/16, 6 pre-fusion BERT layers
    assert len(m.backbone.vit.blocks) == 12 and len(m.backbone.bert.encoder.layer) == 6
    assert m.backbone.embed_dim == 768
    # the seed fixes every weight
    a, b = init_model(port_model(), seed=3), init_model(port_model(), seed=3)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


def test_config_copy_matches_jax_config():
    from uvltrack_tpu.config import load_cfg as jload
    from uvltrack_tpu_torch.config import load_cfg

    for name in ("baseline_base", "baseline_large", "_smoke_cpu"):
        path = f"experiments/uvltrack/{name}.yaml"
        assert load_cfg(path).to_dict() == jload(path).to_dict()


def test_tokenizer_copy_matches_jax_tokenizer(tmp_path):
    from uvltrack_tpu.core.tokenizer import BertTokenizer as JTok
    from uvltrack_tpu_torch.core.tokenizer import BertTokenizer

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "red",
                                "car", "##s", "on", "road", ",", "é"]) + "\n")
    text = "The RED cars, on the Road! 大 éé"
    assert BertTokenizer(str(vocab)).encode_query(text, 12) == \
        JTok(str(vocab)).encode_query(text, 12)
