"""Gateway config generation (port of ``polyaxon_tpu/proxies/gateway.py``):
one nginx server block fronting the port's REST server. /api/v1 and
/streams/v1 proxy to the api service; SSE locations disable buffering
so log tails stream; /healthz short-circuits.
"""

from __future__ import annotations


def render_nginx_conf(
    *,
    api_host: str = "127.0.0.1",
    api_port: int = 8000,
    listen_port: int = 8080,
    server_name: str = "_",
    ssl_cert: str = "",
    ssl_key: str = "",
) -> str:
    upstream = f"{api_host}:{api_port}"
    listen = f"{listen_port} ssl" if ssl_cert else f"{listen_port}"
    ssl_lines = (
        f"    ssl_certificate {ssl_cert};\n"
        f"    ssl_certificate_key {ssl_key};\n"
        if ssl_cert else ""
    )
    return f"""# generated by polyaxon_tpu_torch (plx-torch admin deploy)
server {{
    listen {listen};
    server_name {server_name};
{ssl_lines}
    client_max_body_size 4G;

    location /healthz {{
        proxy_pass http://{upstream};
        proxy_set_header Host $host;
    }}

    location /api/v1/ {{
        proxy_pass http://{upstream};
        proxy_set_header Host $host;
        proxy_set_header X-Real-IP $remote_addr;
        proxy_read_timeout 600s;
    }}

    location /streams/v1/ {{
        proxy_pass http://{upstream};
        proxy_set_header Host $host;
        # SSE log tails: no buffering, long-lived connections.
        proxy_buffering off;
        proxy_cache off;
        proxy_http_version 1.1;
        proxy_set_header Connection "";
        proxy_read_timeout 24h;
    }}
}}
"""
