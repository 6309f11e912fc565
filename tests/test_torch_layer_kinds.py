"""Every layer kind of the reference composed in the port: each of the
twelve (mixer, FFN) pairs, with mixer in (global attention, local-window
attention, Mamba-1, RG-LRU) and FFN in (dense MLP, MoE, none), against the
reference on the same inputs, and the attention logit softcap in decode.

Each kind is a two-layer model at ``smoke_config`` width (d_model 64, the
qwen2-moe smoke's 4/2 attention heads and 8 experts top-2, a Mamba block of
d_inner 128 and state 4, an RG-LRU of width 64, windows of 16), with the
reference's params converted by ``repro_torch.models.convert``:

* the loss and its gradients (float32; the loss at 1e-5, each gradient
  leaf at 1e-5 of its largest magnitude, the rule of
  tests/test_torch_families.py), the backward running the port's autograd
  Functions of the scan entries where the kind has a recurrence;
* decode logits at every step of a prompt (float32, 1e-5) and greedy
  tokens, bit-equal.

The softcap: capped decode logits (``attn_logit_softcap=30``) against the
reference's, and ``ops.flash_attention`` / ``ref.attention_split_ref``
with a cap small enough to bend the scores against the reference's
``_sdpa`` (1e-5).

One model holding all twelve kinds: its param, ZeRO-1 and decode-state
shardings on both production meshes, leaf for leaf against the
reference's, and the dry run's FLOPs in prefill, decode and train against
the reference's lowered ``dot_general``s (tests/test_torch_sharding.py's
and tests/test_torch_dryrun.py's rules).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.attention import _sdpa, causal_window_mask  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ATTN,
    ATTN_LOCAL,
    DENSE,
    MAMBA,
    MOE,
    NONE,
    RGLRU,
    SHAPES,
    LayerSpec,
    ShapeConfig,
)
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_reference, to_reference  # noqa: E402

MIXERS = (ATTN, ATTN_LOCAL, MAMBA, RGLRU)
FFNS = (DENSE, MOE, NONE)
KINDS = [(m, f) for m in MIXERS for f in FFNS]
WINDOW = 16
B, PROMPT, NEW = 2, 20, 4          # the prompt passes the 16-slot rings
# The families' smoke widths, and the recurrent blocks' (falcon-mamba's and
# recurrentgemma's smoke sizes).
RECURRENT = dict(d_inner=128, ssm_state=4, dt_rank=8, ssm_chunk=16,
                 lru_width=64, conv_width=4)


def _cfgs(mixer, ffn, **kw):
    """(reference, port) configs of a two-layer model of one kind."""
    window = WINDOW if mixer == ATTN_LOCAL else 0
    base = dict(num_layers=2, window=window, **RECURRENT, **kw)
    return (jsmoke(jget_config("qwen2-moe-a2.7b")).replace(
                block_pattern=(JLayerSpec(mixer=mixer, ffn=ffn,
                                          window=window),), **base),
            smoke_config(get_config("qwen2-moe-a2.7b")).replace(
                block_pattern=(LayerSpec(mixer=mixer, ffn=ffn,
                                         window=window),), **base))


_PARAMS = {}


def _ref_params(mixer, ffn):
    if (mixer, ffn) not in _PARAMS:
        jcfg, _ = _cfgs(mixer, ffn)
        _PARAMS[mixer, ffn] = jax.tree.map(
            np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    return _PARAMS[mixer, ffn]


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.int32)


def test_kinds_cover_the_reference_composition():
    assert len(KINDS) == 12 and len(set(KINDS)) == 12
    for mixer, ffn in KINDS:
        jcfg, tcfg = _cfgs(mixer, ffn)
        assert tcfg.layer_schedule() == [LayerSpec(mixer, ffn, tcfg.window)] * 2
        assert tcfg.param_counts() == jcfg.param_counts()
        tp = build_model(tcfg).init(0, device="cpu")
        layer = tp["layers"][0]
        assert ("ffn" in layer) == (ffn != NONE)
        assert ("norm2" in layer) == (ffn != NONE)
        # The port's own init has the reference's leaves, shapes and dtypes.
        for a, b in zip(jax.tree.leaves(to_reference(tp, tcfg)),
                        jax.tree.leaves(_ref_params(mixer, ffn)),
                        strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("mixer,ffn", KINDS)
def test_loss_and_gradients_match_reference(mixer, ffn):
    jcfg, tcfg = _cfgs(mixer, ffn, dtype="float32")
    ref_p = _ref_params(mixer, ffn)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    toks, labels = _tokens((B, 24), 3), _tokens((B, 24), 4)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    jp = jax.tree.map(jnp.asarray, ref_p)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, jbatch)[0])(jp)
    tg = from_reference(ref_p, tcfg, device="cpu")
    for t in jax.tree.leaves(tg):
        t.requires_grad_()
    tloss = tm.loss(tg, tbatch)[0]
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5,
                               atol=1e-5)
    grads = to_reference(jax.tree.map(lambda t: t.grad, tg), tcfg)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jgrads),
                    strict=True):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


def _decode_and_tokens(jcfg, tcfg, ref_p):
    """Decode logits of both packages at every step of one prompt (fp32,
    1e-5), then greedy tokens (bit-equal)."""
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref_p, tcfg, device="cpu")
    toks = _tokens((B, PROMPT), 5)
    decode = jax.jit(jm.decode)
    js = jm.init_decode_state(ref_p, B, PROMPT)
    ts = tm.init_decode_state(tp, B, PROMPT)
    for t in range(PROMPT):
        jl, js = decode(ref_p, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tl, ts = tm.decode(tp, ts, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
    prompt = toks[:, :PROMPT // 2]
    want = jserve.greedy_generate(jm, ref_p, jnp.asarray(prompt), NEW)
    got = tserve.greedy_generate(tm, tp, torch.from_numpy(prompt), NEW)
    assert np.asarray(got).tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("mixer,ffn", KINDS)
def test_decode_logits_and_greedy_tokens_match_reference(mixer, ffn):
    jcfg, tcfg = _cfgs(mixer, ffn, dtype="float32")
    _decode_and_tokens(jcfg, tcfg, _ref_params(mixer, ffn))


@pytest.mark.parametrize("mixer", [ATTN, ATTN_LOCAL])
def test_capped_attention_decode_matches_reference(mixer):
    jcfg, tcfg = _cfgs(mixer, DENSE, dtype="float32", attn_logit_softcap=30.0)
    _decode_and_tokens(jcfg, tcfg, _ref_params(mixer, DENSE))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("sq,sk", [(1, 1), (1, 37), (9, 9), (4, 33)])
def test_softcap_bends_the_scores_as_the_reference(sq, sk, window):
    # A cap of 0.5 on scores of magnitude ~1 changes every softmax over
    # more than one key.
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32) * 2
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32) * 2
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    mask = causal_window_mask(sq, sk, window, offset=sk - sq)
    want = np.asarray(_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask=mask, softcap=0.5))
    plain = np.asarray(_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mask=mask))
    if sk > 1:        # one key is weighted 1 whatever its score
        assert np.abs(want - plain).max() > 1e-2
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window,
                              softcap=0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if sq == 1:       # the decode path's split-key plain version
        split = ref.attention_split_ref(
            qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
            causal=True, window=window, softcap=0.5).transpose(1, 2)
        np.testing.assert_allclose(split.numpy(), want, rtol=1e-5, atol=1e-5)


def test_softcap_is_refused_where_the_kernel_lacks_it():
    q = torch.zeros((1, 1, 4, 16))
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2], softcap=-1.0)


# -- the sharding rules and the dry run over every kind --------------------------------
def _all_kinds(**kw):
    """(reference, port) configs of one model holding the twelve kinds."""
    base = dict(num_layers=len(KINDS), window=WINDOW, **RECURRENT, **kw)
    specs = [(m, f, WINDOW if m == ATTN_LOCAL else 0) for m, f in KINDS]
    return (jsmoke(jget_config("qwen2-moe-a2.7b")).replace(
                block_pattern=tuple(JLayerSpec(*s) for s in specs), **base),
            smoke_config(get_config("qwen2-moe-a2.7b")).replace(
                block_pattern=tuple(LayerSpec(*s) for s in specs), **base))


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jax.tree_util.keystr(p): v for p, v in leaves}


def _norm(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _walk_specs(tree, prefix=""):
    if isinstance(tree, shd.P):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_specs(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk_specs(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_specs(v, f"{prefix}[{i}]")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_sharding_specs_of_every_kind_match_reference(multi_pod):
    """Param, ZeRO-1 and decode-state specs of the twelve-kind model, leaf
    for leaf against the reference's over ``AbstractMesh`` (the rules of
    tests/test_torch_sharding.py)."""
    jcfg, cfg = _all_kinds()
    jmesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
             else AbstractMesh((16, 16), ("data", "model")))
    mesh = make_production_mesh(multi_pod=multi_pod)
    jm, tm = jbuild(jcfg), build_model(cfg)
    jp = jm.abstract_params()
    jspec = jshd.param_specs(jp, jmesh)
    jz = _flat(jshd.zero1_specs(jp, jspec, jmesh))
    jspec = _flat(jspec)
    params = tm.abstract_params()
    ours = shd.reference_specs(params, mesh, cfg)
    ours_z = shd.reference_specs(params, mesh, cfg, zero1=True)
    assert sorted(ours) == sorted(jspec)
    for path, (_, spec) in ours.items():
        assert _norm(spec) == _norm(jspec[path]), (path, spec, jspec[path])
        assert _norm(ours_z[path][1]) == _norm(jz[path]), path
    jshape = [s for s in JSHAPES if s.name == "decode_32k"][0]
    shape = [s for s in SHAPES if s.name == "decode_32k"][0]
    js = _flat(jshd.decode_state_specs(jm.decode_state_specs(jshape), jmesh,
                                       jcfg))
    got = dict(_walk_specs(shd.decode_state_specs(
        tm.decode_state_specs(shape), mesh, cfg)))
    want = {}
    for li, spec in enumerate(cfg.layer_schedule()):
        fields = ("h", "conv") if spec.mixer in (MAMBA, RGLRU) else ("k", "v")
        for f in fields:
            want[f".layers[{li}].{f}"] = js[f".blocks[{li}].{f}"][1:]
    assert sorted(got) == sorted(want)
    for k in got:
        assert _norm(got[k]) == _norm(want[k]), (k, got[k], want[k])


def _dot_general_flops(text: str) -> int:
    """2·M·N·K over every ``stablehlo.dot_general`` of a lowered program
    (tests/test_torch_dryrun.py's count)."""
    total = 0
    for line in text.splitlines():
        if "stablehlo.dot_general" not in line:
            continue
        cd = re.search(r"contracting_dims = \[([0-9, ]*)\] x", line)
        sig = re.search(r":\s*\((tensor<[^>]*>),\s*(tensor<[^>]*>)\)\s*->\s*"
                        r"(tensor<[^>]*>)", line)
        dims = [[int(x) for x in re.match(r"tensor<((?:\d+x)*)[a-z0-9]+>",
                                          t).group(1).split("x") if x]
                for t in (sig.group(1), sig.group(3))]
        k = int(np.prod([dims[0][int(i)] for i in cd.group(1).split(",")
                         if i.strip()]))
        total += 2 * int(np.prod(dims[1])) * k
    return total


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dry_run_flops_of_every_kind_equal_reference(kind):
    """Pass A of the dry run on the twelve-kind model (B = 2, S = 32, no
    remat) against the reference's lowered ``dot_general`` FLOPs, plus the
    port's count of its depthwise convs (tests/test_torch_dryrun.py)."""
    Bc, Sc = 2, 32
    jcfg, cfg = _all_kinds(remat_policy="none")
    jm = jbuild(jcfg.replace(scan_layers=False))
    jshape = JShape("smoke", Sc, Bc, kind)
    p, b = jm.abstract_params(), jm.input_specs(jshape)
    if kind == "prefill":
        lo = jax.jit(jm.prefill_logits).lower(p, b)
    elif kind == "decode":
        lo = jax.jit(jm.decode).lower(p, jm.decode_state_specs(jshape), b)
    else:
        lo = jax.jit(lambda p, b: jax.grad(lambda q: jm.loss(q, b)[0])(p)
                     ).lower(p, b)
    conv = 0 if kind == "decode" else sum(
        2 * Bc * Sc * {MAMBA: cfg.d_inner, RGLRU: cfg.lru_width}[s.mixer]
        * cfg.conv_width * (1 if kind == "prefill" else 3)
        for s in cfg.layer_schedule() if s.mixer in (MAMBA, RGLRU))
    c = dryrun.build_cell(cfg.name, ShapeConfig("smoke", Sc, Bc, kind),
                          Mesh(("data",), (1,)), cfg=cfg)
    assert dryrun.count_global(c, nmb=1)["hlo_flops"] == (
        _dot_general_flops(lo.as_text()) + conv)
