"""Membership-inference attack (MIA) harness (mirrors
``repro/privacy/mia.py``).

The paper's headline claim is that pruning on *randomly generated synthetic
data* preserves the client's privacy. "Against Membership Inference Attack:
Pruning is All You Need" (Wang et al., PAPERS.md) defines the measurable
version of that claim: run a membership-inference attack against the model
and report attack accuracy / AUC — a model leaks exactly as much as an
attacker can exploit, no more and no less.

Threat model: the attacker holds a set of candidate examples and black-box
access to the model's posteriors. Members were in the training set,
non-members were not; the attacker must tell them apart. An AUC of 0.5 is
chance (no leakage); 1.0 is total membership disclosure.

Two attacks, both standard:

* ``confidence_attack`` — threshold a per-example confidence signal (the
  true-class posterior by default): members tend to score higher because
  the model memorized them. Reports best balanced accuracy over all
  thresholds plus the threshold-free AUC.
* ``shadow_model_attack`` — train K shadow models on member/non-member
  splits the attacker controls, fit a logistic-regression attack model on
  the shadow posteriors' features, and transfer it to the target. The
  attack's threshold is calibrated on SHADOW scores only — the attacker
  never peeks at target membership labels.

Both report bootstrap confidence intervals (examples resampled with
replacement) so reduced-scale runs carry their own error bars.

All attack math is plain float64 numpy over feature matrices, the
reference's code line for line, so both packages give the same numbers
from the same features. The features are computed from a torch tensor in
float64 on the tensor's device, and only the (N, 4) rows come back to
the host: at an LM's full vocabulary a batch's posteriors are gigabytes.
Model evaluation stays in the caller (``privacy/report.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

# posterior_features column order; every feature is oriented so that HIGHER
# means MORE member-like (memorized examples have high true-class posterior,
# high max posterior, low entropy, low loss).
FEATURE_NAMES = ("true_prob", "max_prob", "neg_entropy", "neg_loss")


# ---------------------------------------------------------------------------
# features from posteriors
# ---------------------------------------------------------------------------

def _features(logits: Any, labels: Any) -> torch.Tensor:
    """(..., C) logits + (...) labels -> (..., 4) float64 features on the
    logits' device."""
    z = torch.as_tensor(logits).to(torch.float64)
    y = torch.as_tensor(labels, device=z.device).to(torch.int64)
    z = z - z.max(dim=-1, keepdim=True).values
    logp = z - torch.log(torch.exp(z).sum(dim=-1, keepdim=True))
    p = torch.exp(logp)
    true_logp = torch.gather(logp, -1, y[..., None])[..., 0]
    entropy = -(p * logp).sum(dim=-1)
    return torch.stack(
        [torch.exp(true_logp), p.max(dim=-1).values, -entropy, true_logp],
        dim=-1)


def posterior_features(logits: Any, labels: Any) -> np.ndarray:
    """(N, C) logits + (N,) int labels → (N, 4) attack features.

    Columns follow ``FEATURE_NAMES``: true-class posterior, max posterior,
    negative entropy, negative NLL. Computed in float64 on the logits'
    device (tie-free scores make the rank statistics exact); only the
    feature rows move to the host.
    """
    return _features(logits, labels).cpu().numpy()


def sequence_features(logits: Any, labels: Any) -> np.ndarray:
    """(B, S, C) logits + (B, S) labels → (B, 4) per-SEQUENCE features.

    The LM analogue of ``posterior_features``: per-token features averaged
    over the sequence — a memorized training sequence has uniformly
    confident next-token posteriors.
    """
    return _features(logits, labels).mean(dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# rank statistics
# ---------------------------------------------------------------------------

def _average_ranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based) with ties sharing their mean rank."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(x.size, np.float64)
    sx = x[order]
    i = 0
    while i < x.size:
        j = i
        while j + 1 < x.size and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def auc(member_scores: Any, nonmember_scores: Any) -> float:
    """Attack AUC via the Mann–Whitney U statistic (tie-corrected).

    Probability a random member outscores a random non-member (+0.5 per
    tie). Threshold-free: the cleanest single leakage number.
    """
    m = np.asarray(member_scores, np.float64).ravel()
    n = np.asarray(nonmember_scores, np.float64).ravel()
    if m.size == 0 or n.size == 0:
        return 0.5
    ranks = _average_ranks(np.concatenate([m, n]))
    u = ranks[: m.size].sum() - m.size * (m.size + 1) / 2.0
    return float(u / (m.size * n.size))


def best_threshold(member_scores: Any, nonmember_scores: Any
                   ) -> Tuple[float, float]:
    """(best balanced accuracy, threshold) for 'score ≥ t → member'.

    Sweeps every candidate threshold (the observed scores plus ±inf
    sentinels). Balanced accuracy = (TPR + TNR) / 2, so imbalanced
    member/non-member pools don't inflate the number; 0.5 is chance.
    """
    m = np.asarray(member_scores, np.float64).ravel()
    n = np.asarray(nonmember_scores, np.float64).ravel()
    cand = np.unique(np.concatenate([m, n, [np.inf]]))
    # vectorized sweep: fine at harness scale (thousands of examples)
    tpr = (m[None, :] >= cand[:, None]).mean(axis=1)
    tnr = (n[None, :] < cand[:, None]).mean(axis=1)
    bal = 0.5 * (tpr + tnr)
    best = int(np.argmax(bal))
    return float(bal[best]), float(cand[best])


def threshold_accuracy(member_scores: Any, nonmember_scores: Any,
                       threshold: float) -> float:
    """Balanced accuracy of 'score ≥ threshold → member' at a FIXED t."""
    m = np.asarray(member_scores, np.float64).ravel()
    n = np.asarray(nonmember_scores, np.float64).ravel()
    return float(0.5 * ((m >= threshold).mean() + (n < threshold).mean()))


def bootstrap_ci(
    stat: Callable[[np.ndarray, np.ndarray], float],
    member_scores: Any,
    nonmember_scores: Any,
    *,
    n_boot: int = 200,
    alpha: float = 0.05,
    seed: int = 0,
) -> Tuple[float, float]:
    """Percentile bootstrap CI for a (member, nonmember) → float statistic.

    Resamples each pool with replacement; deterministic under ``seed``.
    """
    m = np.asarray(member_scores, np.float64).ravel()
    n = np.asarray(nonmember_scores, np.float64).ravel()
    rng = np.random.default_rng(seed)
    vals = np.empty(n_boot, np.float64)
    for b in range(n_boot):
        vals[b] = stat(m[rng.integers(0, m.size, m.size)],
                       n[rng.integers(0, n.size, n.size)])
    lo, hi = np.quantile(vals, [alpha / 2, 1 - alpha / 2])
    return float(lo), float(hi)


# ---------------------------------------------------------------------------
# attack results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttackResult:
    """One attack's numbers against one target model."""

    attack: str                          # "confidence" | "shadow"
    accuracy: float                      # balanced attack accuracy
    auc: float
    accuracy_ci: Tuple[float, float]
    auc_ci: Tuple[float, float]
    n_member: int
    n_nonmember: int
    threshold: float = float("nan")
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["accuracy_ci"] = list(self.accuracy_ci)
        d["auc_ci"] = list(self.auc_ci)
        return d


def confidence_attack(
    member_feats: Any,
    nonmember_feats: Any,
    *,
    feature: int = 0,
    n_boot: int = 200,
    seed: int = 0,
) -> AttackResult:
    """Confidence-threshold attack on one feature column (default:
    true-class posterior). Accuracy is the best balanced accuracy over all
    thresholds — the strongest attacker of this family."""
    mf = np.asarray(member_feats, np.float64)
    nf = np.asarray(nonmember_feats, np.float64)
    m, n = mf[:, feature], nf[:, feature]
    acc, thr = best_threshold(m, n)
    return AttackResult(
        attack="confidence",
        accuracy=acc,
        auc=auc(m, n),
        accuracy_ci=bootstrap_ci(lambda a, b: best_threshold(a, b)[0], m, n,
                                 n_boot=n_boot, seed=seed),
        auc_ci=bootstrap_ci(auc, m, n, n_boot=n_boot, seed=seed + 1),
        n_member=int(m.size),
        n_nonmember=int(n.size),
        threshold=thr,
        extra={"feature": FEATURE_NAMES[feature]},
    )


# ---------------------------------------------------------------------------
# shadow-model attack
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LogisticAttack:
    """Logistic-regression attack model over standardized features."""

    w: np.ndarray
    b: float
    mean: np.ndarray
    std: np.ndarray

    def scores(self, feats: Any) -> np.ndarray:
        x = (np.asarray(feats, np.float64) - self.mean) / self.std
        z = x @ self.w + self.b
        return 1.0 / (1.0 + np.exp(-z))


def fit_logistic(
    feats: np.ndarray,
    labels: np.ndarray,
    *,
    steps: int = 400,
    lr: float = 0.5,
    l2: float = 1e-3,
) -> LogisticAttack:
    """Full-batch gradient-descent logistic regression (no sklearn on the
    box; the attack model is 5 parameters — GD converges in a blink)."""
    x = np.asarray(feats, np.float64)
    y = np.asarray(labels, np.float64)
    mean = x.mean(axis=0)
    std = x.std(axis=0) + 1e-12
    xs = (x - mean) / std
    w = np.zeros(x.shape[1])
    b = 0.0
    for _ in range(steps):
        p = 1.0 / (1.0 + np.exp(-(xs @ w + b)))
        err = p - y
        w -= lr * (xs.T @ err / x.shape[0] + l2 * w)
        b -= lr * float(err.mean())
    return LogisticAttack(w=w, b=b, mean=mean, std=std)


def shadow_attack(
    target_member_feats: Any,
    target_nonmember_feats: Any,
    shadow_member_feats: Any,
    shadow_nonmember_feats: Any,
    *,
    n_boot: int = 200,
    seed: int = 0,
) -> AttackResult:
    """Fit the attack on shadow features, evaluate it on the target.

    The decision threshold is calibrated on the SHADOW scores (best
    balanced accuracy there) and applied unchanged to the target — the
    attacker never uses target membership labels, matching the real
    threat model. AUC is threshold-free as usual.
    """
    sm = np.asarray(shadow_member_feats, np.float64)
    sn = np.asarray(shadow_nonmember_feats, np.float64)
    attack = fit_logistic(
        np.concatenate([sm, sn], axis=0),
        np.concatenate([np.ones(len(sm)), np.zeros(len(sn))]),
    )
    _, thr = best_threshold(attack.scores(sm), attack.scores(sn))
    m = attack.scores(target_member_feats)
    n = attack.scores(target_nonmember_feats)
    return AttackResult(
        attack="shadow",
        accuracy=threshold_accuracy(m, n, thr),
        auc=auc(m, n),
        accuracy_ci=bootstrap_ci(
            lambda a, b: threshold_accuracy(a, b, thr), m, n,
            n_boot=n_boot, seed=seed),
        auc_ci=bootstrap_ci(auc, m, n, n_boot=n_boot, seed=seed + 1),
        n_member=int(m.size),
        n_nonmember=int(n.size),
        threshold=thr,
        extra={"n_shadow_member": int(len(sm)),
               "n_shadow_nonmember": int(len(sn))},
    )


def shadow_model_attack(
    target_member_feats: Any,
    target_nonmember_feats: Any,
    *,
    shadow_features: Callable[[int], Tuple[np.ndarray, np.ndarray]],
    num_shadows: int = 3,
    n_boot: int = 200,
    seed: int = 0,
) -> AttackResult:
    """Full shadow-model attack: pool K shadow models' posterior features.

    ``shadow_features(i)`` must train (or fetch) the i-th shadow model on a
    member/non-member split the attacker controls and return its
    ``(member_feats, nonmember_feats)``. The logistic attack is fit on the
    pooled shadow features and transferred to the target via
    ``shadow_attack``.
    """
    sm, sn = [], []
    for i in range(num_shadows):
        fm, fn = shadow_features(i)
        sm.append(np.asarray(fm, np.float64))
        sn.append(np.asarray(fn, np.float64))
    res = shadow_attack(
        target_member_feats, target_nonmember_feats,
        np.concatenate(sm, axis=0), np.concatenate(sn, axis=0),
        n_boot=n_boot, seed=seed,
    )
    res.extra["num_shadows"] = num_shadows
    return res
