"""The mesh: the reference's placement rules and activation mesh
(``rules``; on one card a mesh shape that the MoE routing groups its
tokens by) and the train mesh's collectives, one process a card
(``spmd``)."""
