from repro_torch.ckpt.checkpoint import save, restore, latest_step  # noqa: F401
