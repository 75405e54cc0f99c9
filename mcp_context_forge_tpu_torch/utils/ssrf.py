"""The SSRF guard for operator-supplied outbound URLs (a copy of the JAX
package's ``utils/ssrf.py``; the ``ssrf_*`` settings).

It runs where URLs enter the catalog (tool and gateway registration and
update, the registration wizard's probe), not per outbound request: the
entries are admin-authored and long-lived, and the hot path stays free of
DNS work. Resolution runs in the executor; a failure blocks or passes per
``ssrf_dns_fail_closed``."""

from __future__ import annotations

import asyncio
import ipaddress
import socket
from urllib.parse import urlsplit

from ..services.base import ValidationFailure


def _parse_networks(csv: str) -> list[ipaddress._BaseNetwork]:
    nets = []
    for part in csv.split(","):
        part = part.strip()
        if part:
            nets.append(ipaddress.ip_network(part, strict=False))
    return nets


def _check_ip(ip: ipaddress._BaseAddress, settings) -> str | None:
    """Return a rejection reason or None."""
    for net in _parse_networks(settings.ssrf_allowed_networks_csv):
        if ip in net:
            return None  # explicit allow wins
    for net in _parse_networks(settings.ssrf_blocked_networks_csv):
        if ip in net:
            return f"address {ip} is in a blocked network"
    if ip.is_loopback:
        return (None if settings.ssrf_allow_localhost
                else f"loopback address {ip} is not allowed")
    if ip.is_private or ip.is_link_local:
        return (None if settings.ssrf_allow_private_networks
                else f"private address {ip} is not allowed")
    return None


async def ensure_url_allowed(settings, url: str) -> None:
    """Raise ValidationFailure when the URL's target is off-limits.

    No-op unless ``ssrf_protection_enabled`` — the flag defaults off so
    single-host deployments (where upstreams ARE localhost) keep working;
    internet-facing gateways flip it on and open pinholes via
    ``ssrf_allowed_networks_csv``.
    """
    if not settings.ssrf_protection_enabled or not url:
        return
    parts = urlsplit(url)
    if parts.scheme not in ("http", "https"):
        raise ValidationFailure(f"URL scheme {parts.scheme!r} is not allowed")
    host = parts.hostname or ""
    if not host:
        raise ValidationFailure("URL has no host")
    blocked_hosts = {h.strip().lower()
                     for h in settings.ssrf_blocked_hosts_csv.split(",")
                     if h.strip()}
    if host.lower() in blocked_hosts:
        raise ValidationFailure(f"host {host!r} is blocked")
    try:
        ip = ipaddress.ip_address(host)
        addresses = [ip]
    except ValueError:
        # hostname: resolve EVERY address — an attacker controls DNS, and
        # one private A record among public ones is the classic rebind
        try:
            infos = await asyncio.get_running_loop().run_in_executor(
                None, socket.getaddrinfo, host, None)
            addresses = [ipaddress.ip_address(info[4][0]) for info in infos]
        except (socket.gaierror, ValueError) as exc:
            if settings.ssrf_dns_fail_closed:
                raise ValidationFailure(
                    f"cannot resolve {host!r}: {exc}") from exc
            return
    for ip in addresses:
        reason = _check_ip(ip, settings)
        if reason:
            raise ValidationFailure(f"SSRF guard: {reason}")
