"""The port's 2-norm of a flat vector (``utils/norms.py``) against a
float64 norm on the CPU, where PyTorch's f32 ``vector_norm`` loses
accuracy with the length, and the Lanczos start vector and recurrence
step that use it."""

from __future__ import annotations

import pytest
import torch

from hessian_llm_vision_tpu_torch.krylov.lanczos import host_recurrence_step, start_vector
from hessian_llm_vision_tpu_torch.utils.norms import norm

N = 1 << 22  # 4.2M entries: f32 vector_norm reads about 1e-4 low here


def _gauss(n: int, seed: int) -> torch.Tensor:
    return torch.randn(n, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n", [1, 1000, N])
def test_norm_matches_float64_on_the_cpu(n):
    v = _gauss(n, 0)
    got = norm(v)
    ref = float(torch.linalg.vector_norm(v.double()))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) / ref - 1) <= 1e-7


def test_norm_keeps_float64_and_reads_f32_vector_norm_error():
    v = _gauss(N, 1)
    ref = float(torch.linalg.vector_norm(v.double()))
    assert float(norm(v.double())) == ref
    print(f"f32 vector_norm at {N}: {float(torch.linalg.vector_norm(v)) / ref - 1:.3e}; "
          f"norm(): {float(norm(v)) / ref - 1:.3e}")


def test_start_vector_and_recurrence_step_are_unit_at_length():
    q = start_vector(_gauss(N, 2), None, N)
    assert abs(float(torch.linalg.vector_norm(q.double())) - 1) <= 1e-6
    w = _gauss(N, 3)
    _, beta, q_next = host_recurrence_step(w, q, torch.zeros(N), torch.zeros(()))
    assert abs(float(torch.linalg.vector_norm(q_next.double())) - 1) <= 1e-6
    r = w.double() - float(torch.dot(q, w)) * q.double()
    assert abs(float(beta) / float(torch.linalg.vector_norm(r)) - 1) <= 1e-6


def test_train_loop_grad_norm_sums_in_float64_on_the_cpu():
    """The train loop's logged ``grad_norm`` over a dict with a leaf of
    2**24 entries, where a sequential f32 sum drifts: within 1e-6 of the
    float64 norm and of optax's ``global_norm``, where the f32 multi-tensor
    reading misses that."""
    import jax.numpy as jnp
    import optax

    from hessian_llm_vision_tpu_torch.train.loop import global_norm

    grads = {"big": _gauss(1 << 24, 4), "small": _gauss(1000, 5).reshape(10, 100)}
    ref = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())))
    got = global_norm(grads)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) / ref - 1) <= 1e-6
    jref = float(optax.global_norm({k: jnp.asarray(v.numpy()) for k, v in grads.items()}))
    assert abs(float(got) / jref - 1) <= 1e-6
    f32 = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads.values())))))
    assert abs(f32 / ref - 1) > 1e-6
