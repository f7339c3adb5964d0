from polyaxon_tpu_torch.cli.main import cli

cli()
