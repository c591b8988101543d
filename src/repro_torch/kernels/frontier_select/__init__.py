"""The frontier_select kernel: ops.py (wrapper) and ref.py (plain version)."""
