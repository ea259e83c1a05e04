"""HuBERT-XLarge — encoder-only audio transformer; the CNN feature
extractor is a STUB (input_specs supplies frame embeddings)
[arXiv:2106.07447; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, head_dim=80,
    is_encoder=True, frontend_stub=True,
    # production parallelism (EXPERIMENTS.md §Perf)
    parallelism="fsdp", head_fsdp=False, q_block=512,
    source="arXiv:2106.07447; unverified",
)
