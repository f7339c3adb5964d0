from polyaxon_tpu_torch.deploy.schemas import V1DeploymentConfig, check_deployment
from polyaxon_tpu_torch.deploy.render import render_deployment

__all__ = ["V1DeploymentConfig", "check_deployment", "render_deployment"]
