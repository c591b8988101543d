"""The opic_update kernel: ops.py (wrapper) and ref.py (plain version)."""
