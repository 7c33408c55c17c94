"""PyTorch GPT-2 port against the flax model, weights carried by name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.models.gpt2 import num_params as jnum_params
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import (
    gpt2_params_from_jax,
    gpt2_params_to_jax,
)
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, num_params
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener, tree_size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T = 3, 16


def _pair(**overrides):
    """Flax tiny GPT-2 with random weights, and the port carrying them."""
    jcfg = JGPT2Config.tiny(**overrides)
    jmodel = JGPT2LMHead(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(3), seq_len=T)
    model = GPT2LMHead(GPT2Config.tiny(**overrides))
    model.load_state_dict(gpt2_params_from_jax(jparams))
    ids = np.random.RandomState(7).randint(0, jcfg.vocab_size, size=(B, T))
    return jmodel, jparams, model, ids


def test_logits_and_loss_match_flax():
    jmodel, jparams, model, ids = _pair()
    jlogits = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    with torch.no_grad():
        logits = model(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)

    mask = np.ones_like(ids)
    mask[1, 10:] = 0  # padded tail: the default loss masks it out
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}
    batch = {"input_ids": torch.as_tensor(ids), "attention_mask": torch.as_tensor(mask)}
    params = dict(model.named_parameters())
    for include_padding in (False, True):
        jl = float(jlosses.lm_loss_fn(jmodel, include_padding=include_padding)(jparams, jbatch))
        with torch.no_grad():
            tl = float(losses.lm_loss_fn(model, include_padding=include_padding)(params, batch))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_softmax_cross_entropy_matches_flax():
    rng = np.random.RandomState(2)
    logits = rng.randn(6, 11).astype(np.float32)
    labels = rng.randint(0, 11, size=6)
    ours = float(losses.softmax_cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels)))
    ref = float(jlosses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_block_q_and_chunked_loss_equal_dense():
    _, _, model, ids = _pair()
    _, _, blocked, _ = _pair(attn_block_q=4)
    x = torch.as_tensor(ids)
    batch = {"input_ids": x, "attention_mask": torch.ones_like(x)}
    params = dict(model.named_parameters())
    with torch.no_grad():
        np.testing.assert_allclose(blocked(x).numpy(), model(x).numpy(), rtol=1e-5, atol=1e-5)
        dense = float(losses.lm_loss_fn(model)(params, batch))
        for chunk in (4, 5, 64):  # divides T-1=15, leaves a ragged chunk, exceeds it
            chunked = float(losses.lm_loss_fn(model, loss_chunk=chunk)(params, batch))
            np.testing.assert_allclose(chunked, dense, rtol=1e-5)
    bad = GPT2LMHead(GPT2Config.tiny(attn_block_q=5))
    with pytest.raises(ValueError, match="does not divide"):
        bad(x)


def test_flat_vector_equals_jax_flattener():
    _, jparams, model, _ = _pair()
    jflat = np.asarray(JFlattener(jparams).flatten(jparams))
    params = {n: p.detach() for n, p in model.named_parameters()}
    fl = Flattener(params)
    flat = fl.flatten(params).numpy()
    np.testing.assert_array_equal(flat, jflat)
    assert fl.size == tree_size(params) == jflat.size
    assert fl.names[-4:] == ["ln_f.bias", "ln_f.scale", "wpe", "wte"]
    back = fl.unflatten(torch.as_tensor(flat))
    for n, p in params.items():
        torch.testing.assert_close(back[n], p, rtol=0, atol=0)


def test_convert_round_trip_and_param_count():
    _, jparams, model, _ = _pair()
    tree = gpt2_params_to_jax(model.state_dict())
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(tree))
    for path, leaf in jleaves:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert num_params(GPT2Config.tiny()) == sum(p.numel() for p in model.parameters())
    for n_pos in (512, 1024):
        assert num_params(GPT2Config.gpt2_124m(n_positions=n_pos)) == jnum_params(
            JGPT2Config.gpt2_124m(n_positions=n_pos)
        )
    assert num_params(GPT2Config.gpt2_124m(n_positions=512)) == 124_046_592


def test_untied_head_matches_flax():
    """``tie_word_embeddings=False``: the flax ``lm_head`` (C, V) kernel,
    carried by name, gives flax's logits and losses."""
    jmodel, jparams, model, ids = _pair(tie_word_embeddings=False)
    assert model.lm_head.kernel.shape == (32, 256) and model.lm_head.bias is None
    assert "lm_head" in jparams
    jlogits = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    with torch.no_grad():
        logits = model(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)
    mask = np.ones_like(ids)
    mask[2, 6:] = 0
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}
    batch = {"input_ids": torch.as_tensor(ids), "attention_mask": torch.as_tensor(mask)}
    params = dict(model.named_parameters())
    jl = float(jlosses.lm_loss_fn(jmodel)(jparams, jbatch))
    with torch.no_grad():
        for chunk in (None, 5):
            tl = float(losses.lm_loss_fn(model, loss_chunk=chunk)(params, batch))
            np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_untied_head_flat_order_and_param_count():
    _, jparams, model, _ = _pair(tie_word_embeddings=False)
    params = {n: p.detach() for n, p in model.named_parameters()}
    np.testing.assert_array_equal(Flattener(params).flatten(params).numpy(),
                                  np.asarray(JFlattener(jparams).flatten(jparams)))
    assert GPT2LMHead.output_kernel(params) is params["lm_head.kernel"]
    cfg = GPT2Config.tiny(tie_word_embeddings=False)
    assert num_params(cfg) == sum(p.numel() for p in model.parameters())
    assert num_params(cfg) == jnum_params(JGPT2Config.tiny(tie_word_embeddings=False))


# every config field is ported: dtype bfloat16 and the precision fields
# (test_torch_precision_model.py), the MoE fields (test_torch_lm_families.py),
# seq_sharding beside model_parallel (test_torch_pipeline.py), the untied head
# (above), attn_remat / attn_unroll (test_torch_remat.py) and dropout (below)
@pytest.mark.parametrize("field,value", [("dropout", 0.1)])
def test_dropout_deterministic_matches_flax(field, value):
    """A dropout config (once refused) run deterministic: the flax logits
    within 1e-5, and the port's dropout-0 model's bit for bit; a rate out
    of [0, 1) raises."""
    jmodel, jparams, model, ids = _pair(**{field: value})
    _, _, plain, _ = _pair()
    jlogits = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids), deterministic=True))
    with torch.no_grad():
        logits = model(torch.as_tensor(ids), deterministic=True)
        assert torch.equal(logits, plain(torch.as_tensor(ids)))
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="dropout"):
        GPT2Config.tiny(dropout=1.0)


def test_dropout_draws_masks_from_a_generator():
    """``deterministic=False``: each entry kept with probability 0.9 and
    scaled by 1/0.9 (flax's ``nn.Dropout``), the masks drawn from the
    generator: the same seed repeats the logits bit for bit, another seed
    does not, and neither equals the deterministic logits."""
    from hessian_llm_vision_tpu_torch.models.gpt2 import dropout

    x = torch.randn(400, 250, generator=torch.Generator().manual_seed(0))
    y = dropout(x, 0.1, False, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) <= 0.01
    assert torch.equal(y[kept], x[kept] / 0.9)
    assert dropout(x, 0.1, True, None) is x and dropout(x, 0.0, False, None) is x
    _, _, model, ids = _pair(dropout=0.1)
    x = torch.as_tensor(ids)
    with torch.no_grad():
        det = model(x)
        a, b, c = (model(x, deterministic=False, generator=torch.Generator().manual_seed(s))
                   for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, det)
