"""Layer-design search space — the paper's OBJECTIVES bullet 1.

Declarative SearchSpace over layer counts, widths, activation cycles and
optimizer settings; enumerated (grid) or sampled (random, for the paper's
1,000-50,000 task regime) into TaskSpecs. The same dataclass drives the
critical-mass / time-vs-layers / activation experiments.

The port's copy of the reference's `repro.core.sweep`, imports rewritten.
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.tasks import TaskSpec


@dataclass
class SearchSpace:
    hidden_layer_counts: Sequence[int] = (1, 2, 4)
    hidden_widths: Sequence[int] = (32, 64, 128)
    activation_sets: Sequence[Tuple[str, ...]] = (("relu",), ("tanh",),
                                                  ("relu", "tanh"))
    learning_rates: Sequence[float] = (1e-3,)
    optimizers: Sequence[str] = ("adam",)        # the Keras/PyBrain axis
    epochs: int = 3
    batch_size: int = 128
    dataset: Any = "default"
    seeds: Sequence[int] = (0,)

    def grid(self) -> List[Dict[str, Any]]:
        out = []
        for (nl, w, acts, lr, opt, seed) in itertools.product(
                self.hidden_layer_counts, self.hidden_widths,
                self.activation_sets, self.learning_rates, self.optimizers,
                self.seeds):
            out.append({"hidden_sizes": [w] * nl, "activations": list(acts),
                        "lr": lr, "optimizer": opt, "epochs": self.epochs,
                        "batch_size": self.batch_size, "dataset": self.dataset,
                        "seed": seed})
        return out

    def sample(self, n: int, seed: int = 0) -> List[Dict[str, Any]]:
        rng = random.Random(seed)
        out = []
        for i in range(n):
            nl = rng.choice(list(self.hidden_layer_counts))
            w = rng.choice(list(self.hidden_widths))
            out.append({
                "hidden_sizes": [w] * nl,
                "activations": list(rng.choice(list(self.activation_sets))),
                "lr": rng.choice(list(self.learning_rates)),
                "optimizer": rng.choice(list(self.optimizers)),
                "epochs": self.epochs, "batch_size": self.batch_size,
                "dataset": self.dataset, "seed": rng.choice(list(self.seeds)) + i,
            })
        return out

    def tasks(self, session_id: str, *, n: Optional[int] = None,
              seed: int = 0, kind: str = "dnn_train") -> List[TaskSpec]:
        payloads = self.grid() if n is None else self.sample(n, seed)
        return [TaskSpec.make(session_id, kind, p) for p in payloads]
