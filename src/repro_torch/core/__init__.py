"""The selection stack on PyTorch: oracles, ThresholdGreedy engines, round
primitives, MapReduce drivers and the selector API."""

from repro_torch.core.functions import (FacilityLocation, FeatureCoverage,
                                        GraphCut, LogDetDiversity,
                                        MutualInformationGaussian,
                                        SaturatedCoverage, SubmodularOracle,
                                        WeightedCoverage)
from repro_torch.core.mapreduce import (MRConfig, SelectionResult,
                                        multi_epoch_sim, two_round_sim)
from repro_torch.core.selector import (ALGORITHMS, ORACLE_NAMES,
                                       DistributedSelector, SelectorSpec,
                                       make_oracle)
from repro_torch.core.threshold import (GreedyStats, pack_by_mask,
                                        threshold_filter, threshold_greedy)

__all__ = [
    "FacilityLocation", "FeatureCoverage", "GraphCut", "LogDetDiversity",
    "MutualInformationGaussian", "SaturatedCoverage", "SubmodularOracle",
    "WeightedCoverage",
    "MRConfig", "SelectionResult", "multi_epoch_sim", "two_round_sim",
    "ALGORITHMS", "ORACLE_NAMES", "DistributedSelector", "SelectorSpec",
    "make_oracle",
    "GreedyStats", "pack_by_mask", "threshold_filter", "threshold_greedy",
]
