"""The batch drivers: ``python -m nm03_capstone_project_tpu_torch.cli.sequential``,
``.parallel`` and ``.test_pipeline``."""
