"""Strategic classification: cost functions, batched best responses, the
strategic loss and the robustness evaluation.

Counterpart of ``adaptive_classifier_tpu/strategic.py``.  An agent at
embedding ``x`` moves to the candidate ``y`` that maximises ``max-prob(f(y))
− cost(x, y)``.  The candidates are ``x`` itself, then per-feature ±2.0
sweeps (10 deltas per feature) truncated to ``num_candidates``, then
Gaussian filler only when the sweep under-produces (``10·D < K − 1``, so
below 5 features).  All ``B × K`` candidates are scored by one forward of
the head, a ``[B·K, D] × [D, C]`` product; chunking bounds the ``[B, K, D]``
candidate tensor.  Nothing here is a kernel: plain torch on the
embeddings' device.  The random draws (the Gaussian filler and the
evaluator's gaming coins) come from ``torch.Generator``s through
``_candidate_noise`` and ``_gaming_draws``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Coefficients = Union[Dict[str, float], np.ndarray, torch.Tensor, Sequence[float]]
Forward = Callable[[torch.Tensor], torch.Tensor]

#: the sweep's deltas: the JAX package's ``jnp.linspace(-2.0, 2.0, 10)`` in
#: float32, value for value (numpy's and torch's linspace differ from it in
#: the last bits of four entries)
_DELTAS = (-2.0, -1.5555555820465088, -1.1111111640930176, -0.666666567325592,
           -0.22222226858139038, 0.22222228348255157, 0.6666667461395264,
           1.1111111640930176, 1.5555555820465088, 2.0)


def _as_vector(coeffs: Coefficients, feature_names: Optional[List[str]]) -> torch.Tensor:
    if isinstance(coeffs, dict):
        if feature_names is None:
            raise ValueError("feature_names required when using dict coefficients")
        return torch.tensor([float(coeffs.get(n, 0.0)) for n in feature_names],
                            dtype=torch.float32)
    return _vec(coeffs).detach().cpu().reshape(-1)


def _vec(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def _fit_dim(vec: torch.Tensor, dim: int, device: torch.device) -> torch.Tensor:
    """The coefficient vector at the embedding width: as it is, a scalar
    tiled, zero-padded (extra dims move for free) or truncated."""
    vec = vec.to(device)
    n = vec.shape[0]
    if n == dim:
        return vec
    if n == 1:
        return vec.expand(dim).clone()
    if n < dim:
        out = torch.zeros((dim,), dtype=torch.float32, device=device)
        out[:n] = vec
        return out
    return vec[:dim]


def _candidate_noise(generator: Optional[torch.Generator], shape: Tuple[int, ...],
                     device: torch.device) -> torch.Tensor:
    """Standard normal draws of the Gaussian filler."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=generator, device=device)


def _gaming_draws(generator: Optional[torch.Generator], n: int,
                  device: torch.device) -> torch.Tensor:
    """One uniform [0, 1) draw per test row: the row games when its draw is
    below the gaming level."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(42)
    return torch.rand((n,), generator=generator, device=device)


class StrategicCostFunction:
    """Base: the cost of moving ``x → y``, and the batched best response."""

    num_candidates: int = 50

    def compute_cost(self, x, y):  # pragma: no cover - abstract
        raise NotImplementedError

    def compute_cost_batch(self, x: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
        """``cost(x_b, cand_bk)`` for ``[B, D]`` x and ``[B, K, D]``
        candidates → ``[B, K]``."""
        raise NotImplementedError

    def _generate_candidates(self, x: torch.Tensor,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[B, K, D]`` candidates: x itself, then the per-feature sweeps
        (candidate ``1 + j`` moves feature ``j // 10`` by delta ``j % 10``),
        then the Gaussian filler (σ 0.5) if the sweep is short of ``K``."""
        B, D = x.shape
        K = self.num_candidates
        n_sweep = min(K - 1, D * 10)
        j = torch.arange(n_sweep, device=x.device)
        deltas = torch.tensor(_DELTAS, dtype=torch.float32, device=x.device)
        cands = x[:, None, :].expand(B, 1 + n_sweep, D).clone()
        cands[:, 1 + j, j // 10] += deltas[j % 10]
        n_rand = K - 1 - n_sweep
        if n_rand > 0:
            noise = _candidate_noise(generator, (B, n_rand, D), x.device) * 0.5
            cands = torch.cat([cands, x[:, None, :] + noise], dim=1)
        return cands

    def compute_best_response_batch(self, x: torch.Tensor, f: Forward,
                                    generator: Optional[torch.Generator] = None
                                    ) -> torch.Tensor:
        """argmax over the candidates of ``max-prob(f(cand)) − cost(x,
        cand)`` (the first on ties), one forward for all ``B × K`` points;
        ``f`` maps ``[M, D]`` to probabilities ``[M, C]``."""
        x = torch.atleast_2d(x).to(torch.float32)
        B, D = x.shape
        with torch.no_grad():
            cands = self._generate_candidates(x, generator)
            K = cands.shape[1]
            probs = f(cands.reshape(B * K, D))
            utility = probs.max(dim=-1).values.reshape(B, K) - self.compute_cost_batch(x, cands)
            best = torch.argmax(utility, dim=1)
            return cands[torch.arange(B, device=x.device), best]

    def compute_best_response(self, x, f: Forward,
                              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Single-sample form: ``[D]`` → ``[D]``."""
        return self.compute_best_response_batch(_vec(x).reshape(1, -1), f, generator)[0]

    def compute_best_response_chunked(self, x: torch.Tensor, f: Forward,
                                      generator: Optional[torch.Generator] = None,
                                      chunk: int = 256) -> torch.Tensor:
        """``compute_best_response_batch`` over row chunks of ``chunk``: the
        candidate tensor stays at ``chunk·K·D`` (at the production width D
        33,280, a 256-row chunk is 1.7 GB), the rows identical (the sweep is
        deterministic; the filler exists only below 5 features)."""
        B = x.shape[0]
        if B <= chunk:
            return self.compute_best_response_batch(x, f, generator)
        return torch.cat([self.compute_best_response_batch(x[s:s + chunk], f, generator)
                          for s in range(0, B, chunk)], dim=0)


class SeparableCostFunction(StrategicCostFunction):
    """``c(x, y) = max{0, c2·y − c1·x}``."""

    def __init__(self, c1_coefficients: Coefficients, c2_coefficients: Coefficients,
                 feature_names: Optional[List[str]] = None):
        if isinstance(c1_coefficients, dict) and feature_names is None:
            raise ValueError("feature_names required when using dict coefficients")
        self.c1 = _as_vector(c1_coefficients, feature_names)
        self.c2 = _as_vector(c2_coefficients, feature_names)
        self.feature_names = feature_names

    def compute_cost(self, x, y) -> torch.Tensor:
        x, y = _vec(x), _vec(y)
        c1 = _fit_dim(self.c1, x.shape[-1], x.device)
        c2 = _fit_dim(self.c2, y.shape[-1], y.device)
        return torch.clamp_min(torch.dot(c2, y) - torch.dot(c1, x), 0.0)

    def compute_cost_batch(self, x: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
        c1 = _fit_dim(self.c1, x.shape[-1], x.device)
        c2 = _fit_dim(self.c2, x.shape[-1], x.device)
        c1x = x @ c1                                   # [B]
        c2y = cands @ c2                               # [B, K]
        return torch.clamp_min(c2y - c1x[:, None], 0.0)


class LinearCostFunction(SeparableCostFunction):
    """``c(x, y) = ⟨α, y − x⟩₊``."""

    def __init__(self, alpha: Coefficients, feature_names: Optional[List[str]] = None):
        if isinstance(alpha, dict) and feature_names is None:
            raise ValueError("feature_names required when using dict coefficients")
        vec = _as_vector(alpha, feature_names)
        super().__init__(vec, vec, feature_names)
        self.alpha = vec

    def compute_cost(self, x, y) -> torch.Tensor:
        x, y = _vec(x), _vec(y)
        a = _fit_dim(self.alpha, x.shape[-1], x.device)
        return torch.clamp_min(torch.dot(a, y - x), 0.0)


class CostFunctionFactory:
    """A cost function by name; dict coefficients without feature names
    take the dict's own keys."""

    @staticmethod
    def create_cost_function(cost_type: str, cost_coefficients: Coefficients,
                             feature_names: Optional[List[str]] = None, **kwargs):
        if isinstance(cost_coefficients, dict) and feature_names is None:
            feature_names = list(cost_coefficients.keys())
        if cost_type == "linear":
            return LinearCostFunction(cost_coefficients, feature_names)
        if cost_type == "separable":
            c2 = kwargs.get("c2_coefficients", cost_coefficients)
            return SeparableCostFunction(cost_coefficients, c2, feature_names)
        raise ValueError(f"Unknown cost function type: {cost_type}")


class StrategicOptimizer:
    """The strategic training loss."""

    def __init__(self, cost_function: StrategicCostFunction):
        self.cost_function = cost_function

    def strategic_loss_terms(self, forward: Forward, embeddings: torch.Tensor,
                             labels: torch.Tensor,
                             generator: Optional[torch.Generator] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(regular CE, strategic penalty), combined as CE + λ·penalty.

        ``forward`` maps ``[M, D]`` to masked logits.  The penalty is the CE
        on the best-response points whose argmax left the true label,
        summed and divided by the batch size.  The best responses are
        chosen without gradient (an argmax over a fixed sweep); gradients
        flow through the forward on the chosen points."""
        labels = labels.to(torch.int64)
        logp = torch.log_softmax(forward(embeddings), dim=-1)
        regular = -logp.gather(1, labels[:, None]).mean()
        with torch.no_grad():
            br = self.cost_function.compute_best_response_batch(
                embeddings.detach(), lambda z: torch.softmax(forward(z), dim=-1), generator)
        s_logits = forward(br)
        s_pred = torch.argmax(s_logits, dim=-1)
        s_ce = -torch.log_softmax(s_logits, dim=-1).gather(1, labels[:, None])[:, 0]
        flipped = (s_pred != labels).to(torch.float32)
        penalty = torch.sum(s_ce * flipped) / max(embeddings.shape[0], 1)
        return regular, penalty

    def strategic_loss(self, forward: Forward, embeddings: torch.Tensor,
                       labels: torch.Tensor, strategic_lambda: float = 0.1,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        regular, penalty = self.strategic_loss_terms(forward, embeddings, labels, generator)
        return regular + strategic_lambda * penalty


class StrategicEvaluator:
    """Accuracy under simulated gaming: at each level, that share of the test
    rows (by a uniform draw per row) moves to its best response."""

    def __init__(self, cost_function: StrategicCostFunction):
        self.cost_function = cost_function

    def evaluate_robustness(self, forward: Forward, test_embeddings: torch.Tensor,
                            test_labels: torch.Tensor,
                            gaming_levels: Sequence[float] = (0.0, 0.5, 1.0),
                            generator: Optional[torch.Generator] = None
                            ) -> Dict[str, float]:
        """``accuracy_gaming_<level>`` per level, ``robustness_score`` (the
        accuracy at 0.0 less that at 1.0) and ``relative_robustness``
        (their ratio).  ``forward`` maps ``[M, D]`` to logits."""
        x = torch.as_tensor(test_embeddings).to(torch.float32)
        y = torch.as_tensor(test_labels).to(x.device, torch.int64)
        results: Dict[str, float] = {}
        with torch.no_grad():
            for level in gaming_levels:
                games = _gaming_draws(generator, x.shape[0], x.device) < level
                br = self.cost_function.compute_best_response_chunked(
                    x, lambda z: torch.softmax(forward(z), dim=-1), generator)
                gamed = torch.where(games[:, None], br, x)
                preds = torch.argmax(forward(gamed), dim=-1)
                # the float32 mean as XLA computes it: the sum times 1/N
                results[f"accuracy_gaming_{level}"] = float(
                    (preds == y).to(torch.float32).sum() * (1.0 / max(x.shape[0], 1)))
        a0 = results.get("accuracy_gaming_0.0", 0.0)
        a1 = results.get("accuracy_gaming_1.0", 0.0)
        results["robustness_score"] = a0 - a1
        results["relative_robustness"] = a1 / a0 if a0 > 0 else 0.0
        return results
