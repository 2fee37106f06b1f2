"""The paper's own architecture: tabular MLP classifier (models/dnn.py).
Default shape matches the paper's sweep midpoint; the SearchSpace varies
hidden_sizes / activations around it."""
from repro_torch.configs.base import MLPConfig

CONFIG = MLPConfig(n_features=16, n_classes=4, hidden_sizes=(128, 128),
                   activations=("relu",))
