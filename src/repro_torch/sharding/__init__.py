"""The mesh's single-card meaning: an activation mesh shape that the MoE
routing groups its tokens by (``rules``)."""
