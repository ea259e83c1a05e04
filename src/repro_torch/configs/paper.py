"""The paper's own 'architecture': the distributed submodular selection
workload (ground-set size, k, oracle) used by launch/select.py and the
selection dry-run."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SelectionWorkload:
    name: str = "paper-selector"
    n_total: int = 16_777_216      # 16M candidate pool
    feat_dim: int = 1024           # embedding width
    k: int = 65_536                # coreset size
    oracle: str = "facility_location"
    reference_size: int = 4096
    t: int = 1
    eps: float = 0.1


CONFIG = SelectionWorkload()
