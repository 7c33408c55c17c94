"""Data generators and loaders (numpy, seeded)."""

from hessian_llm_vision_tpu_torch.data.synthetic import (
    make_spirals,
    markov_token_batches,
    random_image_batches,
    random_token_batches,
)
from hessian_llm_vision_tpu_torch.data.vision import (
    add_gaussian_noise,
    augment_batch,
    get_class_subset,
    load_cifar10,
    load_mnist,
    load_mnist_as_cifar,
)

__all__ = [
    "add_gaussian_noise",
    "augment_batch",
    "get_class_subset",
    "load_cifar10",
    "load_mnist",
    "load_mnist_as_cifar",
    "make_spirals",
    "markov_token_batches",
    "random_image_batches",
    "random_token_batches",
]
