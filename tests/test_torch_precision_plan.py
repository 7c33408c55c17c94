"""The precision ladder's pure functions, planner walk, guard walk and plan
files, held to the JAX package on the CPU.

Real tier errors exist only on the card (JAX on the CPU ignores matmul
precision, and TF32 does not exist there), so the walks run on injected
errors, as the JAX package's own tests do: a synthetic quadratic whose
curvature is perturbed per spec (the planner) and a scripted probe (the
guard).  Pure functions must match exactly; the planners' errors within
1e-5."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.krylov import autoprec as jautoprec
from hessian_llm_vision_tpu.krylov import precplan as jprecplan
from hessian_llm_vision_tpu.models import precision as jprecision
from hessian_llm_vision_tpu.optim import precision_guard as jguard
from hessian_llm_vision_tpu_torch.io.checkpoints import save_checkpoint
from hessian_llm_vision_tpu_torch.krylov import autoprec, precplan
from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.optim import precision_guard as guard

N_LAYERS = 4
DIM = 6
ERR_TOL = 1e-5  # planner errors, port against JAX

SPECS = [None, "default", "high", "BF16_BF16_F32_X6", ("high", "default", None, "highest"),
         {"block_matmul_precision": "default", "attn_scores_precision": "high"}]


def _same(fn_ours, fn_ref, *args):
    """Both return equal values, or both raise the same exception type."""
    try:
        ref = fn_ref(*args)
    except Exception as e:  # noqa: BLE001 - the type is compared below
        with pytest.raises(type(e)):
            fn_ours(*args)
        return
    assert fn_ours(*args) == ref


@pytest.mark.parametrize("case", [
    *[("per_layer_precision", (s, N_LAYERS)) for s in SPECS[:5]],
    ("per_layer_precision", (("high", "default"), N_LAYERS)),
    ("per_layer_precision", ("fast", N_LAYERS)),
    *[("uniform_precision", (s,)) for s in (None, "high", ("high", "high"), ("high", None))],
    *[("spec_to_overrides", (s,)) for s in SPECS],
    *[("escalation_prefixes", (n,)) for n in (1, 2, 4, 12, 24)],
    *[("prefix_block_spec", (n, b)) for n in (1, 4, 12) for b in (0, 1, 3, 12)],
    *[("spec_json", (s,)) for s in SPECS],
], ids=lambda c: f"{c[0]}-{c[1]!r}")
def test_pure_functions_equal_jax(case):
    name, args = case
    pairs = {
        "per_layer_precision": (precision.per_layer_precision, jprecision.per_layer_precision),
        "uniform_precision": (precision.uniform_precision, jprecision.uniform_precision),
        "spec_to_overrides": (autoprec.spec_to_overrides, jautoprec.spec_to_overrides),
        "escalation_prefixes": (autoprec.escalation_prefixes, jautoprec.escalation_prefixes),
        "prefix_block_spec": (autoprec.prefix_block_spec, jautoprec.prefix_block_spec),
        # the JSON the plan files hold, and the spec decoded back from it
        "spec_json": (
            lambda s: (json.dumps(precplan._encode_spec(s)),
                       precplan._decode_spec(json.loads(json.dumps(precplan._encode_spec(s))))),
            lambda s: (json.dumps(jprecplan._encode_spec(s)),
                       jprecplan._decode_spec(json.loads(json.dumps(jprecplan._encode_spec(s))))),
        ),
    }
    _same(*pairs[name], *args)


def test_presets_map_to_the_card_tiers():
    """The table of ``models/precision.py``; a preset with no tier on the
    card is refused naming the five it runs (JAX lets XLA judge it)."""
    tiers = {p: precision.tier_of(p) for p in (None, "default", "high", "highest",
                                                *precision.PRESETS)}
    assert tiers == {None: None, "default": "bf16", "high": "fp32", "highest": "fp32",
                     "BF16_BF16_F32": "bf16", "TF32_TF32_F32": "tf32",
                     "BF16_BF16_F32_X6": "fp32", "F32_F32_F32": "fp32", "F64_F64_F64": "fp64"}
    jprecision.per_layer_precision("BF16_BF16_F32_X3", 2)  # JAX passes it on
    with pytest.raises(ValueError, match="F64_F64_F64"):
        precision.per_layer_precision("BF16_BF16_F32_X3", 2)


# --------------------------------------------------------------- planner

def _weight(spec, layer_errs, op_errs):
    """The JAX test's error model (tests/unit/test_autoprec.py): a block at
    'default' adds layer_errs[i]; an op type left at 'default' adds
    op_errs[op]."""
    overrides = spec if isinstance(spec, dict) else {"block_matmul_precision": spec}
    bmp = overrides.get("block_matmul_precision")
    per = list(bmp) if isinstance(bmp, (tuple, list)) else [bmp] * N_LAYERS
    eps = sum(e for p, e in zip(per, layer_errs) if p == "default")
    if any(p == "default" for p in per):
        for op in ("attn_scores", "attn_matmul", "mlp_matmul"):
            if overrides.get(f"{op}_precision") != "high":
                eps += op_errs.get(op, 0.0)
    return eps


def _factories(layer_errs, op_errs=None):
    """The same quadratic 0.5 xᵀ(B + eps u uᵀ)x for both packages, from numpy."""
    op_errs = op_errs or {}
    base = np.diag(np.linspace(1.0, 3.0, DIM)).astype(np.float32)
    u = (np.ones(DIM) / np.sqrt(DIM)).astype(np.float32)

    def jmake(spec):
        H = jnp.asarray(base + _weight(spec, layer_errs, op_errs) * np.outer(u, u))
        return lambda params, batch: 0.5 * params["x"] @ H @ params["x"]

    def tmake(spec):
        H = torch.as_tensor(base + _weight(spec, layer_errs, op_errs) * np.outer(u, u))
        return lambda params, batch: 0.5 * params["x"] @ H @ params["x"]

    return jmake, tmake


def _prefix_candidates():
    return [(f"prefix-{b}", jautoprec.prefix_block_spec(N_LAYERS, b))
            for b in jautoprec.escalation_prefixes(N_LAYERS)]


@pytest.mark.parametrize("layer_errs,op_errs,candidates", [
    ([0.0] * N_LAYERS, None, [("mixed", "default")]),
    ([1.0, 0.5, 0.0, 0.0], None, _prefix_candidates()),
    ([0.0] * N_LAYERS, {"attn_scores": 1.0},
     [("mixed", "default")] + jautoprec.op_split_candidates()),
    ([0.0] * N_LAYERS, {"mlp_matmul": 1e-4, "attn_matmul": 1.0},
     [("mixed", "default")] + jautoprec.op_split_candidates()),
], ids=["clean_mixed", "prefix_ladder", "scores_split", "attn_split"])
def test_planner_walk_equals_jax(layer_errs, op_errs, candidates):
    jmake, tmake = _factories(layer_errs, op_errs)
    v = np.random.default_rng(0).standard_normal(DIM).astype(np.float32)
    kw = dict(ritz_iters=DIM, tol=1e-3, candidates=candidates)
    jplan = jautoprec.auto_precision_plan(jmake, {"x": jnp.zeros(DIM)}, None,
                                          vector=jnp.asarray(v), **kw)
    plan = autoprec.auto_precision_plan(tmake, {"x": torch.zeros(DIM)}, None,
                                        vector=torch.as_tensor(v), **kw)
    assert [a.label for a in plan.arms] == [a.label for a in jplan.arms]
    assert (plan.label, plan.block_precision, plan.hvp_precision) == (
        jplan.label, jplan.block_precision, jplan.hvp_precision)
    np.testing.assert_allclose([a.ritz_rel_err for a in plan.arms],
                               [a.ritz_rel_err for a in jplan.arms], atol=ERR_TOL)
    np.testing.assert_allclose(plan.referee_extremes, jplan.referee_extremes, rtol=ERR_TOL)


def test_default_ladder_is_rebased_on_the_card():
    """mixed -> blocks-TF32, then the fp32 referee: the JAX ladder's strict
    and X6 rungs are the referee's tier on the card and are not probed."""
    assert [label for label, _ in autoprec.default_candidates()] == [
        "mixed (all blocks 1-pass bf16)", "blocks-TF32 + head high"]
    _, tmake = _factories([0.25] * N_LAYERS)
    logs = []
    plan = autoprec.auto_precision_plan(tmake, {"x": torch.zeros(DIM)}, None,
                                        generator=torch.Generator().manual_seed(0),
                                        ritz_iters=DIM, log=logs.append)
    assert plan.label == "blocks-TF32 + head high"
    assert plan.block_precision == {"block_matmul_precision": "TF32_TF32_F32"}
    assert plan.arms[0].ritz_rel_err > 1e-3 >= plan.ritz_rel_err
    # everything failing: strict blocks equal the referee, so the fallback
    # is the referee itself, with no strict arm probed
    logs = []
    plan = autoprec.auto_precision_plan(
        tmake, {"x": torch.zeros(DIM)}, None, generator=torch.Generator().manual_seed(0),
        ritz_iters=DIM, log=logs.append,
        candidates=[("mixed", "default"), ("x6", {"block_matmul_precision": autoprec.X6}),
                    ("bad", "BF16_BF16_F32_X3")])
    assert plan.label == "referee fallback (highest)" and plan.hvp_precision == "highest"
    assert [a.label for a in plan.arms] == ["mixed"]
    assert any("x6: the referee's tier map, not probed" in line for line in logs)
    assert any("bad: SKIPPED" in line for line in logs)
    assert "probed mixed" in plan.describe()


def test_planner_argument_checks():
    _, tmake = _factories([0.0] * N_LAYERS)
    with pytest.raises(ValueError, match="exactly one"):
        autoprec.auto_precision_plan(tmake, {"x": torch.zeros(DIM)}, None)
    with pytest.raises(ValueError, match="ritz_iters"):
        autoprec.auto_precision_plan(tmake, {"x": torch.zeros(DIM)}, None,
                                     generator=torch.Generator(), ritz_iters=0)


# ----------------------------------------------------------------- guard

class _Trainer:
    def __init__(self):
        self.applied = []

    def set_refresh_tier(self, tier):
        self.applied.append(tier.label)


def _walk(mod, errors, start):
    """Drive a guard through an initial resolve and six refresh boundaries
    with a scripted probe; returns (tier index after each call, events,
    summary, tiers the trainer was given)."""
    it = iter(errors)
    tiers = [mod.GuardTier(label, None, "high") for label in ("cheap", "middle", "top")]
    g = mod.RefreshPrecisionGuard(tiers, referee_loss_fn=None, recheck_every=2,
                                  start_index=start, probe_fn=lambda tier, p, b: next(it),
                                  log=lambda s: None)
    trainer, index = _Trainer(), []
    g.resolve_initial(trainer, None, None, step=0)
    index.append(g.index)
    # eig_max: baseline, steady, then a 5x jump (growth), then steady
    for i, eig in enumerate((1.0, 1.2, 6.0, 6.1, 6.2, 40.0), start=1):
        g.maybe_recheck(trainer, None, None, step=3 * i, refresh_index=i, eig_max=eig)
        index.append(g.index)
    return index, [e.__dict__ for e in g.events], g.summary(), trainer.applied


@pytest.mark.parametrize("errors,start", [
    ([1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4], 0),
    ([5e-3, 1e-4, 3e-3, 1e-3, 1e-4, 9e-3, 9e-3], 0),
    ([1e-4, 1e-2, 1e-2, 1e-2, 1e-2, 1e-2], 1),
], ids=["steady", "escalates_twice", "pinned_to_top_warns"])
def test_guard_walk_equals_jax(errors, start):
    ours, ref = _walk(guard, errors, start), _walk(jguard, errors, start)
    assert ours[0] == ref[0]  # tier index after each call
    assert ours[1] == ref[1]  # events
    assert ours[2].keys() == ref[2].keys() and ours[2] == ref[2]
    assert ours[3] == ref[3]


def test_default_tiers_and_start_rungs_are_the_jax_ladder_on_the_card():
    """Each pinned --refresh_precision starts on the card counterpart of
    the JAX start rung: bf16x3 'high' is fp32 here, the top rung."""
    on_card = {"mixed (all blocks 1-pass bf16)": "mixed (all blocks 1-pass bf16)",
               "strict (all blocks high)": "highest (fp32 everywhere)",
               "blocks-X6 + head high": "highest (fp32 everywhere)",
               "highest (X6 everywhere)": "highest (fp32 everywhere)",
               "high": "highest", "highest": "highest"}
    for factory in (lambda spec: None, None):
        jtiers, tiers = jguard.default_tiers(factory, None), guard.default_tiers(factory, None)
        for rp in ("default", "mixed", "high", "highest"):
            j = jtiers[jguard.tier_index_for(jtiers, rp)].label
            assert tiers[guard.tier_index_for(tiers, rp)].label == on_card[j], (rp, j)
    assert [(t.label, t.precision) for t in guard.default_tiers(lambda s: None, None)] == [
        ("mixed (all blocks 1-pass bf16)", "high"), ("blocks-TF32 + head high", "high"),
        ("highest (fp32 everywhere)", "highest")]


# ------------------------------------------------------------ plan files

def _plan(label="mixed"):
    arm = autoprec.PrecisionArm(label, "default", "high", 1e-4, 0.1, (-1.0, 2.0))
    return autoprec.AutoPrecisionPlan("default", "high", label, 1e-4, (-1.0, 2.0), (arm,))


def test_plan_round_trip_and_rejections(tmp_path):
    path = str(tmp_path / "ck.autoprec.json")
    ctx = precplan.plan_context(probe_batch={"input_ids": torch.zeros(4, 8, dtype=torch.long)},
                                tol=1e-3, ritz_iters=10, candidate_labels=("a", "b"))
    precplan.save_plan(path, _plan(), fingerprint="fp", context=ctx, provenance={"x": 1})
    assert precplan.load_plan(path, fingerprint="fp", context=ctx) == _plan()
    assert not os.path.exists(path + ".tmp")
    assert precplan.load_plan(path, fingerprint="other", context=ctx) is None
    assert precplan.load_plan(path, fingerprint="fp", context={**ctx, "tol": 1e-2}) is None
    assert precplan.load_plan(str(tmp_path / "absent.json"), fingerprint="fp",
                              context=ctx) is None
    with open(path) as f:
        doc = json.load(f)
    # the JAX package's loader reads the port's file (same schema and version)
    assert jprecplan.load_plan(path, fingerprint="fp", context=ctx).label == "mixed"
    doc["version"] = precplan.PLAN_VERSION + 1
    with open(path, "w") as f:
        json.dump(doc, f)
    assert precplan.load_plan(path, fingerprint="fp", context=ctx) is None
    with open(path, "w") as f:
        f.write("{not json")
    assert precplan.load_plan(path, fingerprint="fp", context=ctx) is None
    assert precplan.default_plan_path("/a/ck.pt") == jprecplan.default_plan_path(
        "/a/ck.pt") == "/a/ck.pt.autoprec.json"
    assert precplan.default_plan_path("/a/dir/") == "/a/dir.autoprec.json"


def test_checkpoint_and_params_fingerprints(tmp_path):
    rng = np.random.default_rng(0)
    params = {"b": torch.as_tensor(rng.standard_normal(5).astype(np.float32)),
              "a": torch.as_tensor(rng.standard_normal((300, 1000)).astype(np.float32))}
    ck = str(tmp_path / "ck.pt")
    save_checkpoint(ck, params)
    fp = precplan.checkpoint_fingerprint(ck)
    assert fp.startswith("sha256-ckpt:") and fp == precplan.checkpoint_fingerprint(ck)
    assert os.path.getsize(ck) > 1 << 20  # the head-and-tail branch
    save_checkpoint(ck, {**params, "b": params["b"] + 1})
    assert precplan.checkpoint_fingerprint(ck) != fp
    assert precplan.checkpoint_fingerprint(str(tmp_path / "missing")) is None
    # a directory is walked as the JAX package walks an Orbax checkpoint
    d = tmp_path / "dir"
    d.mkdir()
    (d / "x.bin").write_bytes(b"abc")
    assert precplan.checkpoint_fingerprint(str(d)) == jprecplan.checkpoint_fingerprint(str(d))
    pf = precplan.params_fingerprint(params)
    assert pf.startswith("sha256:") and pf == precplan.params_fingerprint(dict(params))
    assert precplan.params_fingerprint({**params, "b": params["b"] * 2}) != pf
