"""Configuration schema of the port (copies of trlx_tpu.data)."""
