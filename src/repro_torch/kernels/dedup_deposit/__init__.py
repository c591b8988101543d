"""The dedup_deposit kernel: ops.py (wrapper) and ref.py (plain version)."""
