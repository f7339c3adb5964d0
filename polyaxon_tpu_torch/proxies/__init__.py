from polyaxon_tpu_torch.proxies.gateway import render_nginx_conf

__all__ = ["render_nginx_conf"]
