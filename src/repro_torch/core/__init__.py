"""The selection stack on PyTorch: oracles, ThresholdGreedy engines, round
primitives on the sim and mesh substrates, MapReduce drivers, fault
injection, the distributed baselines and the selector API."""

from repro_torch.core.constraints import (CONSTRAINT_NAMES, Cardinality,
                                          Constraint, Knapsack,
                                          PartitionMatroid, make_constraint)
from repro_torch.core.distributed_baselines import mz_coresets, rand_greedi
from repro_torch.core.faults import (CORRUPT_CANARY, FAULT_KINDS, FaultPlan,
                                     FaultyRounds, chaos_plan, fault_summary)
from repro_torch.core.functions import (AdversarialThreshold,
                                        ExemplarClustering, FacilityLocation,
                                        FeatureCoverage, GraphCut,
                                        LogDetDiversity,
                                        MutualInformationGaussian,
                                        SaturatedCoverage, SubmodularOracle,
                                        TPOracle, WeightedCoverage,
                                        adversarial_schedule,
                                        bind_query, consumes_query_params,
                                        make_adversarial_instance)
from repro_torch.core.mapreduce import (MRConfig, QueryBatch, SelectionResult,
                                        dense_two_round_sim, make_query_batch,
                                        multi_epoch_mesh, multi_epoch_sim,
                                        multi_threshold_mesh,
                                        multi_threshold_sim,
                                        sparse_two_round_sim,
                                        two_round_batch_mesh,
                                        two_round_batch_sim,
                                        two_round_known_opt_mesh,
                                        two_round_known_opt_sim,
                                        two_round_mesh, two_round_sim)
from repro_torch.core.rounds import FaultRecord, MeshRounds, SimRounds
from repro_torch.core.selector import (ALGORITHMS, OPT_FREE_ALGORITHMS,
                                       ORACLE_NAMES, TP_ORACLES,
                                       DistributedSelector, SelectorSpec,
                                       make_oracle)
from repro_torch.core.threshold import (GreedyStats, pack_by_mask,
                                        threshold_filter, threshold_greedy,
                                        threshold_greedy_batch)

__all__ = [
    "mz_coresets", "rand_greedi",
    "CORRUPT_CANARY", "FAULT_KINDS", "FaultPlan", "FaultyRounds",
    "chaos_plan", "fault_summary",
    "CONSTRAINT_NAMES", "Cardinality", "Constraint", "Knapsack",
    "PartitionMatroid", "make_constraint",
    "AdversarialThreshold", "ExemplarClustering", "FacilityLocation",
    "FeatureCoverage", "GraphCut", "LogDetDiversity",
    "MutualInformationGaussian", "SaturatedCoverage", "SubmodularOracle",
    "TPOracle", "WeightedCoverage", "adversarial_schedule", "bind_query",
    "consumes_query_params", "make_adversarial_instance",
    "MRConfig", "QueryBatch", "SelectionResult", "dense_two_round_sim",
    "make_query_batch", "multi_epoch_mesh", "multi_epoch_sim",
    "multi_threshold_mesh", "multi_threshold_sim", "sparse_two_round_sim",
    "two_round_batch_mesh", "two_round_batch_sim",
    "two_round_known_opt_mesh", "two_round_known_opt_sim", "two_round_mesh",
    "two_round_sim", "FaultRecord", "MeshRounds", "SimRounds",
    "ALGORITHMS", "OPT_FREE_ALGORITHMS", "ORACLE_NAMES", "TP_ORACLES",
    "DistributedSelector", "SelectorSpec", "make_oracle",
    "GreedyStats", "pack_by_mask", "threshold_filter", "threshold_greedy",
    "threshold_greedy_batch",
]
