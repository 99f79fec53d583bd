"""AdamW over stacked per-agent tensors."""
