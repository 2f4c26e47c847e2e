from probunet_torch.train.steps import make_sample_fn  # noqa: F401
