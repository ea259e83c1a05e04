"""Carrying data across from the JAX side.

The system has no weights: what crosses is numpy data (the corpus sharded
(m, n/m, d) with its ids and validity, the coverage oracles' optional (d,)
weights, FacilityLocation's (r, d) reference set, SaturatedCoverage's and
GraphCut's (d,) ground-set total, a log-det oracle's (U, logdet, size)
state, and the sample rounds' U[0, 1) draws).  These helpers turn such
arrays into the port's tensors and oracle on a given device, so a test can
feed the same inputs to both packages.  numpy bfloat16 arrays (the
``ml_dtypes`` type that JAX hands out) arrive as torch.bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.functions import (FacilityLocation, FeatureCoverage,
                                        GraphCut, LogDetDiversity,
                                        MutualInformationGaussian,
                                        SaturatedCoverage, WeightedCoverage)


def tensor(a, device="cpu") -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``, keeping its dtype; bfloat16 is carried bit for bit."""
    a = np.array(a)  # a writable copy: JAX hands out read-only arrays
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _f32(a, device):
    return None if a is None else tensor(np.asarray(a, np.float32), device)


def shard(feats_mk, ids_mk, valid_mk, device="cpu"):
    """The sharded corpus (m, n/m, d), ids (m, n/m) int32 and validity
    (m, n/m) bool, as the sim drivers take them."""
    return (tensor(feats_mk, device),
            tensor(np.asarray(ids_mk, np.int32), device),
            tensor(np.asarray(valid_mk, bool), device))


def feature_coverage(feat_dim: int, weights=None, use_kernel: bool = False,
                     device="cpu") -> FeatureCoverage:
    """The FeatureCoverage oracle with the JAX side's optional weights."""
    return FeatureCoverage(feat_dim=feat_dim, weights=_f32(weights, device),
                           use_kernel=use_kernel, device=torch.device(device))


def facility_location(feat_dim: int, reference, use_kernel: bool = False,
                      device="cpu") -> FacilityLocation:
    """The FacilityLocation oracle over the JAX side's (r, d) reference
    set, kept in its dtype (a bf16 set is carried bit for bit)."""
    return FacilityLocation(feat_dim=feat_dim,
                            reference=tensor(reference, device),
                            use_kernel=use_kernel, device=torch.device(device))


def weighted_coverage(feat_dim: int, weights=None, use_kernel: bool = False,
                      device="cpu") -> WeightedCoverage:
    """The WeightedCoverage oracle with the JAX side's optional (U,) item
    weights, kept float32 (None: all ones)."""
    return WeightedCoverage(feat_dim=feat_dim, weights=_f32(weights, device),
                            use_kernel=use_kernel, device=torch.device(device))


def saturated_coverage(feat_dim: int, total, alpha: float = 0.25,
                       weights=None, use_kernel: bool = False,
                       device="cpu") -> SaturatedCoverage:
    """The SaturatedCoverage oracle with the JAX side's (d,) ground-set
    total and optional (d,) weights, both kept float32, so the cap
    alpha * total is the same f32 product in both packages."""
    return SaturatedCoverage(feat_dim=feat_dim, total=_f32(total, device),
                             alpha=alpha, weights=_f32(weights, device),
                             use_kernel=use_kernel, device=torch.device(device))


def graph_cut(feat_dim: int, total, lam: float = 0.5,
              use_kernel: bool = False, device="cpu") -> GraphCut:
    """The GraphCut oracle with the JAX side's (d,) ground-set total, kept
    float32."""
    return GraphCut(feat_dim=feat_dim, total=_f32(total, device), lam=lam,
                    use_kernel=use_kernel, device=torch.device(device))


def log_det(feat_dim: int, k_max: int, alpha: float = 1.0,
            use_kernel: bool = False, device="cpu") -> LogDetDiversity:
    """The LogDetDiversity oracle with the JAX side's k_max and alpha."""
    return LogDetDiversity(feat_dim=feat_dim, k_max=k_max, alpha=alpha,
                           use_kernel=use_kernel, device=torch.device(device))


def mutual_information(feat_dim: int, k_max: int, noise: float = 1.0,
                       use_kernel: bool = False,
                       device="cpu") -> MutualInformationGaussian:
    """The MutualInformationGaussian oracle with the JAX side's k_max and
    noise."""
    return MutualInformationGaussian(feat_dim=feat_dim, k_max=k_max,
                                     noise=noise, use_kernel=use_kernel,
                                     device=torch.device(device))


def logdet_state(U, logdet, size, device="cpu"):
    """A JAX log-det state (U (k, d) f32, logdet () f32, size () int32),
    or one stacked over lanes ((L, k, d), (L,), (L,)), as the port's tuple
    state."""
    return (_f32(U, device), _f32(logdet, device),
            tensor(np.asarray(size, np.int32), device))


def uniforms(draws, device="cpu") -> torch.Tensor:
    """The sample rounds' draws, (E, m, n/m) or (m, n/m), as float32."""
    return _f32(draws, device)
