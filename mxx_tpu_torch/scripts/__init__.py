"""Entry points of the port that produce the repo's tables, each run as
`python -m mxx_tpu_torch.scripts.<name>` (counterparts of `scripts/`)."""
