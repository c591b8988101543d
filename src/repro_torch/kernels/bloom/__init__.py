"""The bloom kernel: ops.py (wrapper) and ref.py (plain version)."""
