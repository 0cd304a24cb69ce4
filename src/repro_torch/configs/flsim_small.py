"""The paper's own experiment models (Section 4); port of
``repro/configs/flsim_small.py``.

- 3-conv CNN + FC head on CIFAR-10-shaped inputs
- 4-hidden-layer MLP on flattened images
- logistic regression on MNIST-shaped inputs
"""
from repro_torch.configs.base import ModelConfig

FLSIM_CNN = ModelConfig(
    name="flsim-cnn", family="small", n_layers=3, d_model=64, n_heads=1,
    n_kv_heads=1, d_ff=128, vocab_size=10,
    notes="3 CNN layers + FC classification head, CIFAR-10 shaped (32x32x3)",
    source="paper §4.1",
)

FLSIM_MLP = ModelConfig(
    name="flsim-mlp", family="small", n_layers=4, d_model=256, n_heads=1,
    n_kv_heads=1, d_ff=256, vocab_size=10,
    notes="4-hidden-layer MLP on flattened 32x32x3 images (paper's sklearn stand-in)",
    source="paper §4.2",
)

FLSIM_LOGREG = ModelConfig(
    name="flsim-logreg", family="small", n_layers=0, d_model=784, n_heads=1,
    n_kv_heads=1, d_ff=0, vocab_size=10,
    notes="logistic regression, MNIST shaped (paper §4.6 scale experiments)",
    source="paper §4.6",
)
