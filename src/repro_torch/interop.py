"""Carrying data across from the JAX side.

The system has no weights: what crosses is numpy data (the corpus sharded
(m, n/m, d) with its ids and validity, FeatureCoverage's optional (d,)
weights, FacilityLocation's (r, d) reference set, and the sample rounds'
U[0, 1) draws).  These helpers turn such
arrays into the port's tensors and oracle on a given device, so a test can
feed the same inputs to both packages.  numpy bfloat16 arrays (the
``ml_dtypes`` type that JAX hands out) arrive as torch.bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.functions import FacilityLocation, FeatureCoverage


def tensor(a, device="cpu") -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``, keeping its dtype; bfloat16 is carried bit for bit."""
    a = np.array(a)  # a writable copy: JAX hands out read-only arrays
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def shard(feats_mk, ids_mk, valid_mk, device="cpu"):
    """The sharded corpus (m, n/m, d), ids (m, n/m) int32 and validity
    (m, n/m) bool, as the sim drivers take them."""
    return (tensor(feats_mk, device),
            tensor(np.asarray(ids_mk, np.int32), device),
            tensor(np.asarray(valid_mk, bool), device))


def feature_coverage(feat_dim: int, weights=None, use_kernel: bool = False,
                     device="cpu") -> FeatureCoverage:
    """The FeatureCoverage oracle with the JAX side's optional weights."""
    w = None if weights is None else tensor(np.asarray(weights, np.float32),
                                            device)
    return FeatureCoverage(feat_dim=feat_dim, weights=w,
                           use_kernel=use_kernel, device=torch.device(device))


def facility_location(feat_dim: int, reference, use_kernel: bool = False,
                      device="cpu") -> FacilityLocation:
    """The FacilityLocation oracle over the JAX side's (r, d) reference
    set, kept in its dtype (a bf16 set is carried bit for bit)."""
    return FacilityLocation(feat_dim=feat_dim,
                            reference=tensor(reference, device),
                            use_kernel=use_kernel, device=torch.device(device))


def uniforms(draws, device="cpu") -> torch.Tensor:
    """The sample rounds' draws, (E, m, n/m) or (m, n/m), as float32."""
    return tensor(np.asarray(draws, np.float32), device)
