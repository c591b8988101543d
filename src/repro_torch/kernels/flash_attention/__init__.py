"""The flash_attention kernel: ops.py (wrapper) and ref.py (plain version)."""
