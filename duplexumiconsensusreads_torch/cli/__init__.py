from duplexumiconsensusreads_torch.cli.main import main  # noqa: F401
