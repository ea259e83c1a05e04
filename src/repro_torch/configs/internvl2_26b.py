"""InternVL2-26B — InternViT frontend (STUB: input_specs supplies patch
embeddings) + InternLM2-20B decoder backbone [arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92553, head_dim=128,
    num_image_tokens=1024, frontend_stub=True,
    # production parallelism (EXPERIMENTS.md §Perf)
    parallelism="fsdp", head_fsdp=False, q_block=512, loss_chunk=512,
    source="arXiv:2404.16821; hf",
)
