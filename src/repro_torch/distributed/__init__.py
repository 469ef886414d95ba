"""Distributed pieces: gradient compression, placement rules and the
costing of a placed step."""
