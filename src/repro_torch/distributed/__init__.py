"""Distributed-training pieces: gradient compression."""
