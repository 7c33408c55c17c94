"""The port's vision and MLP models against the JAX package's on the CPU:
SpiralMLP, SimpleNet, VGG-16 (classifier width 64) and ResNet-50 (one
Bottleneck per stage, which still runs the 7x7/2 stem, the (0, 1)-padded
pool and every stride-2 block and downsampling shortcut), from the JAX
package's init params carried by ``models/convert.py``, on the same numpy
inputs: flat vectors equal element by element; logits, loss, gradient and
HVP within 1e-5 relative.

ResNet-50 in BatchNorm train mode is held to the JAX package in float64 on
both sides (the JAX model at ``dtype=float64`` under ``jax.enable_x64``),
where the two formulas agree to 4e-8: in float32 at this size the batch's
own statistics amplify rounding, and the two packages' f32 gradients lie
1.7e-5 (JAX) and 6.3e-6 (port) from the float64 one, HVPs 4.0e-5 and
1.3e-5 (batch of 8, measured on the CPU), so their f32 difference (3.8e-5
for the HVP) measures that conditioning, not the port; the f32 test holds
the port no farther from float64 than the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call

from hessian_llm_vision_tpu.models import VGG16 as JVGG16
from hessian_llm_vision_tpu.models import ResNet50 as JResNet50
from hessian_llm_vision_tpu.models import SimpleNet as JSimpleNet
from hessian_llm_vision_tpu.models import SpiralMLP as JSpiralMLP
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp
from hessian_llm_vision_tpu_torch.models import VGG16, ResNet50, SimpleNet, SpiralMLP, losses
from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.models.convert import variables_from_jax, variables_to_jax
from hessian_llm_vision_tpu_torch.models.resnet import batch_stats
from hessian_llm_vision_tpu_torch.models.vgg import Conv, max_pool, same_pads
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

RTOL = 1e-5

CASES = {
    "spiral": (JSpiralMLP(width=16, depth=2), SpiralMLP(width=16, depth=2), (6, 2), 3),
    "simplenet": (JSimpleNet(), SimpleNet(), (5, 28, 28, 1), 10),
    "vgg16": (JVGG16(classifier_width=64), VGG16(classifier_width=64), (4, 32, 32, 3), 10),
    "resnet50": (JResNet50(stage_sizes=(1, 1, 1, 1)), ResNet50(stage_sizes=(1, 1, 1, 1)),
                 (8, 32, 32, 3), 10),
}


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _setup(name, seed=0):
    jmodel, model, shape, classes = CASES[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randint(0, classes, shape[0])
    kw = {"use_running_average": False} if name == "resnet50" else {}
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, *shape[1:])), **kw)
    params, stats = variables_from_jax(variables)
    v = rng.randn(Flattener(params).size).astype(np.float32)
    return jmodel, model, variables, params, stats, x, y, v


def _closures(name, jmodel, model, variables, stats, train_mode):
    if name == "resnet50":
        return (jlosses.classification_loss_fn_bn(jmodel, variables["batch_stats"],
                                                  bn_train_mode=train_mode),
                losses.classification_loss_fn_bn(model, stats, bn_train_mode=train_mode))
    return jlosses.classification_loss_fn(jmodel), losses.classification_loss_fn(model)


def _jax_reference(jloss, jparams, x, y, v):
    """(loss, flat grad, flat HVP) of the JAX closure."""
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    loss, g = jax.jit(jax.value_and_grad(jloss))(jparams, batch)
    flat, unravel = ravel_pytree(jparams)
    hv = jax.jit(lambda p, t: jax.jvp(jax.grad(lambda q: jloss(q, batch)), (p,), (t,))[1])(
        jparams, unravel(jnp.asarray(v, flat.dtype)))
    return float(loss), np.asarray(ravel_pytree(g)[0]), np.asarray(ravel_pytree(hv)[0])


def _port(ploss, params, x, y, v):
    fl = Flattener(params)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y).long()}
    loss, g = grad_and_loss(ploss, params, batch)
    vec = fl.unflatten(torch.from_numpy(v).to(next(iter(params.values())).dtype))
    hv = hvp(ploss, params, batch, vec, precision=None)
    flat = lambda d: torch.cat([d[n].reshape(-1) for n in fl.names]).numpy()  # noqa: E731
    return float(loss), flat(g), flat(hv)


@pytest.mark.parametrize("name,train_mode", [("spiral", False), ("simplenet", False),
                                             ("vgg16", False), ("resnet50", False)],
                         ids=["spiral", "simplenet", "vgg16", "resnet50_eval"])
def test_logits_loss_grad_hvp_match_jax(name, train_mode):
    jmodel, model, variables, params, stats, x, y, v = _setup(name)
    np.testing.assert_array_equal(Flattener(params).flatten(params).numpy(),
                                  np.asarray(ravel_pytree(variables["params"])[0]))
    kw = {"use_running_average": not train_mode} if name == "resnet50" else {}
    jlogits = jmodel.apply(variables, jnp.asarray(x), **kw)
    logits = functional_call(model, {**params, **stats}, (torch.from_numpy(x),), kw)
    assert _rel(logits.detach().numpy(), jlogits) <= RTOL
    jloss, ploss = _closures(name, jmodel, model, variables, stats, train_mode)
    ref = _jax_reference(jloss, variables["params"], x, y, v)
    ours = _port(ploss, params, x, y, v)
    assert abs(ours[0] / ref[0] - 1) <= RTOL
    assert _rel(ours[1], ref[1]) <= RTOL
    assert _rel(ours[2], ref[2]) <= RTOL


def _float64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


def test_resnet_train_mode_matches_jax_in_float64():
    _, model, variables, params, stats, x, y, v = _setup("resnet50")
    with jax.enable_x64(True):
        j64 = JResNet50(stage_sizes=(1, 1, 1, 1), dtype=jnp.float64)
        var64 = _float64(dict(variables))
        jloss = jlosses.classification_loss_fn_bn(j64, var64["batch_stats"], bn_train_mode=True)
        jlogits = j64.apply(var64, jnp.asarray(x, jnp.float64), use_running_average=False,
                            mutable=["batch_stats"])[0]
        ref = _jax_reference(jloss, var64["params"], x.astype(np.float64), y, v)
    p64 = {n: t.double() for n, t in params.items()}
    logits = functional_call(model, {**p64, **stats}, (torch.from_numpy(x).double(),),
                             {"use_running_average": False})
    assert _rel(logits.detach().numpy(), jlogits) <= RTOL
    ours = _port(losses.classification_loss_fn_bn(model, stats, bn_train_mode=True), p64, x, y, v)
    assert abs(ours[0] / ref[0] - 1) <= RTOL
    assert _rel(ours[1], ref[1]) <= RTOL
    assert _rel(ours[2], ref[2]) <= RTOL


def test_resnet_train_mode_f32_no_farther_from_float64_than_jax():
    jmodel, model, variables, params, stats, x, y, v = _setup("resnet50")
    ploss = losses.classification_loss_fn_bn(model, stats, bn_train_mode=True)
    truth = _port(ploss, {n: t.double() for n, t in params.items()}, x, y, v)
    jref = _jax_reference(jlosses.classification_loss_fn_bn(
        jmodel, variables["batch_stats"], bn_train_mode=True), variables["params"], x, y, v)
    ours = _port(ploss, params, x, y, v)
    for i in (1, 2):  # gradient, HVP
        assert _rel(ours[i], truth[i]) <= max(RTOL, _rel(jref[i], truth[i]))


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
def test_batch_stats_are_never_written(train_mode):
    _, model, _, params, stats, x, y, v = _setup("resnet50")
    before = {n: t.clone() for n, t in stats.items()}
    ploss = losses.classification_loss_fn_bn(model, stats, bn_train_mode=train_mode)
    _port(ploss, params, x, y, v)
    assert set(before) == {n for n, _ in model.named_buffers()}
    assert not set(before) & {n for n, _ in model.named_parameters()}
    for n, t in batch_stats(model).items():
        assert torch.equal(t, before[n]) and torch.equal(stats[n], before[n]), n


@pytest.mark.parametrize("n,k,s", [(32, 7, 2), (16, 3, 2), (8, 3, 2), (8, 1, 2), (32, 3, 1),
                                   (7, 3, 2), (5, 2, 2)])
def test_same_padding_is_flax_asymmetric(n, k, s):
    ref = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert same_pads(n, k, s) == tuple(ref)


def test_conv_and_pool_see_a_one_pixel_shift():
    """The stem's 7x7/2 conv pads (2, 3) and the 3x3/2 pool (0, 1) with
    -inf: PyTorch's symmetric padding gives outputs of the same size,
    shifted by a pixel, which these comparisons would see."""
    import flax.linen as fnn

    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jconv = fnn.Conv(5, (7, 7), strides=(2, 2), padding="SAME", use_bias=False)
    jvars = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    conv = Conv(3, 5, 7, stride=2, use_bias=False)
    kernel = torch.from_numpy(np.array(jvars["params"]["kernel"]))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = functional_call(conv, {"kernel": kernel}, (nchw,)).detach()
    ref = np.asarray(jconv.apply(jvars, jnp.asarray(x)))
    assert _rel(out.permute(0, 2, 3, 1).numpy(), ref) <= RTOL
    sym = torch.nn.functional.conv2d(nchw, kernel.permute(3, 2, 0, 1), stride=2, padding=3)
    assert sym.shape == out.shape and _rel(sym.permute(0, 2, 3, 1).numpy(), ref) > 0.1
    pooled = max_pool(out, 3, 2, "SAME").permute(0, 2, 3, 1).numpy()
    jpooled = np.asarray(fnn.max_pool(jnp.asarray(ref), (3, 3), strides=(2, 2), padding="SAME"))
    assert pooled.shape == jpooled.shape == (2, 8, 8, 5)
    np.testing.assert_allclose(pooled, jpooled, rtol=RTOL, atol=1e-6)
    sym = torch.nn.functional.max_pool2d(out, 3, 2, padding=1).permute(0, 2, 3, 1)
    assert sym.shape == pooled.shape and not np.allclose(sym.numpy(), jpooled)


@pytest.mark.parametrize("cls,jcls,leaves,size", [
    (VGG16, JVGG16, 32, 33_638_218), (ResNet50, JResNet50, 161, 23_528_522),
], ids=["vgg16", "resnet50"])
def test_full_width_models_have_the_jax_names_and_sizes(cls, jcls, leaves, size):
    kw = {"use_running_average": False} if cls is ResNet50 else {}
    shapes = jax.eval_shape(lambda: jcls().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                                **kw))
    jflat = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
             for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    with torch.device("meta"):
        model = cls()
    params = dict(model.named_parameters())
    fl = Flattener(params)
    assert fl.size == size and len(fl.names) == leaves
    assert fl.names == list(jflat)
    assert all(tuple(params[n].shape) == tuple(jflat[n]) for n in fl.names)
    if cls is ResNet50:
        jstats = jax.tree_util.tree_flatten_with_path(shapes["batch_stats"])[0]
        assert sorted(batch_stats(model)) == sorted(
            ".".join(str(getattr(k, "key", k)) for k in path) for path, _ in jstats)


def test_init_is_flax_lecun_normal_and_seeded():
    a = VGG16(classifier_width=64, generator=torch.Generator().manual_seed(3))
    b = VGG16(classifier_width=64, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    k = a.Conv_12.kernel  # (3, 3, 512, 512): fan-in 4608
    assert abs(float(k.std()) * np.sqrt(3 * 3 * 512) - 1) < 0.01
    assert float(k.abs().max()) <= 2 * np.sqrt(1 / 4608) / 0.87962566103423978 + 1e-7
    assert float(a.Conv_12.bias.abs().max()) == 0.0
    r = ResNet50(stage_sizes=(1, 1, 1, 1), generator=torch.Generator().manual_seed(0))
    bn = r.Bottleneck_0.BatchNorm_0
    assert bool((bn.scale == 1).all() and (bn.bias == 0).all() and (bn.mean == 0).all()
                and (bn.var == 1).all())


def test_variables_carry_both_ways():
    _, _, variables, params, stats, *_ = _setup("resnet50")
    back = variables_to_jax(params, stats)
    for key in ("params", "batch_stats"):
        a = jax.tree_util.tree_leaves(back[key])
        b = jax.tree_util.tree_leaves(variables[key])
        assert len(a) == len(b) and all(np.array_equal(x, np.asarray(y)) for x, y in zip(a, b))
    assert "batch_stats" not in variables_to_jax(params, {})


def test_convolutions_take_the_precision_tier():
    """Under the bf16 tier ("default") a convolution runs on bf16 operands,
    under the float64 preset on float64 ones; without a scope it is the
    plain f32 convolution."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 4, 6, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 4, 3, 3).astype(np.float32))
    conv = torch.nn.functional.conv2d
    assert torch.equal(precision.conv2d(x, w, padding=1), conv(x, w, padding=1))
    with precision.precision_scope("default"):
        low = precision.conv2d(x, w, padding=1)
    assert low.dtype == torch.float32
    assert torch.equal(low, conv(x.bfloat16(), w.bfloat16(), padding=1).float())
    assert not torch.equal(low, conv(x, w, padding=1))
    with precision.precision_scope("F64_F64_F64"):
        high = precision.conv2d(x, w, padding=1)
    assert torch.equal(high, conv(x.double(), w.double(), padding=1).float())
