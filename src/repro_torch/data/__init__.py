from repro_torch.data import graphchallenge  # noqa: F401
