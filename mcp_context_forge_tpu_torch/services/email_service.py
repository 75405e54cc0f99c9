"""SMTP email notifications for auth/team lifecycle events.

A copy of the JAX package's ``services/email_service.py``.

Reference: ``services/email_notification_service.py`` (password reset,
lockout mail over smtplib + Jinja templates) and the ``smtp_*`` settings
family (``config.py``). Differences, deliberate:

- stdlib ``smtplib`` driven through the shared executor — the event loop
  never blocks on a slow MX;
- plain-text bodies rendered from f-string templates (no template dir to
  ship or sandbox; the reference's HTML mail adds an XSS surface the
  gateway doesn't need);
- every send is fail-open and audited: notification failure must never
  fail the request that triggered it (matches the reference's
  swallow-and-log posture).
"""

from __future__ import annotations

import asyncio
import logging
import smtplib
import ssl
from email.message import EmailMessage
from email.utils import formataddr
from typing import Any

from .base import AppContext

logger = logging.getLogger(__name__)


class EmailNotificationService:
    def __init__(self, ctx: AppContext) -> None:
        self._ctx = ctx
        # tests and the admin surface read this; a bounded outbox keeps a
        # record of the last few sends without growing unbounded
        self.sent: list[dict[str, Any]] = []

    @property
    def enabled(self) -> bool:
        settings = self._ctx.settings
        return bool(settings.smtp_enabled and settings.smtp_host)

    async def send(self, to_email: str, subject: str, body: str) -> bool:
        """Queue-and-forget send; returns delivery success."""
        if not self.enabled:
            logger.debug("smtp disabled; dropping mail to %s (%s)",
                         to_email, subject)
            return False
        try:
            ok = await asyncio.get_running_loop().run_in_executor(
                None, self._send_sync, to_email, subject, body)
        except Exception as exc:
            logger.warning("email to %s failed: %s", to_email, exc)
            return False
        if ok:
            self.sent.append({"to": to_email, "subject": subject})
            del self.sent[:-20]
        return ok

    def _send_sync(self, to_email: str, subject: str, body: str) -> bool:
        settings = self._ctx.settings
        msg = EmailMessage()
        msg["From"] = formataddr((settings.smtp_from_name,
                                  settings.smtp_from_email))
        msg["To"] = to_email
        msg["Subject"] = subject
        msg.set_content(body)
        timeout = settings.smtp_timeout_seconds
        if settings.smtp_use_ssl:
            client: smtplib.SMTP = smtplib.SMTP_SSL(
                settings.smtp_host, settings.smtp_port, timeout=timeout,
                context=ssl.create_default_context())
        else:
            client = smtplib.SMTP(settings.smtp_host, settings.smtp_port,
                                  timeout=timeout)
        try:
            if settings.smtp_use_tls and not settings.smtp_use_ssl:
                client.starttls(context=ssl.create_default_context())
            if settings.smtp_user:
                client.login(settings.smtp_user, settings.smtp_password)
            client.send_message(msg)
            return True
        finally:
            try:
                client.quit()
            except Exception:
                pass

    # ------------------------------------------------------ template mails

    async def send_account_lockout(self, to_email: str,
                                   locked_minutes: float) -> bool:
        settings = self._ctx.settings
        return await self.send(
            to_email,
            f"{settings.app_name}: account temporarily locked",
            f"Your account {to_email} was locked after repeated failed\n"
            f"login attempts. It unlocks automatically in "
            f"{locked_minutes:.0f} minutes.\n\n"
            f"If this wasn't you, contact your administrator.\n")

    async def send_team_invitation(self, to_email: str, team_name: str,
                                   invited_by: str, token: str) -> bool:
        settings = self._ctx.settings
        # acceptance is an AUTHENTICATED POST (the invitee must prove they
        # are the invited email), so the mail carries the token for the UI
        # or API rather than a clickable link that would 405
        return await self.send(
            to_email,
            f"{settings.app_name}: invitation to team {team_name!r}",
            f"{invited_by} invited you to join team {team_name!r}.\n\n"
            f"Invitation token: {token}\n\n"
            f"Accept while signed in at {settings.app_domain} — or:\n"
            f"  curl -X POST {settings.app_domain}/teams/invitations/accept"
            f" \\\n    -H 'authorization: Bearer <your token>'"
            f" -d '{{\"token\": \"{token}\"}}'\n")

    async def send_password_reset(self, to_email: str, token: str,
                                  expires_minutes: float) -> bool:
        settings = self._ctx.settings
        reset_url = (f"{settings.app_domain}/auth/password/reset"
                     f"?token={token}")
        return await self.send(
            to_email,
            f"{settings.app_name}: password reset",
            f"A password reset was requested for {to_email}.\n\n"
            f"Reset (valid {expires_minutes:.0f} min): {reset_url}\n\n"
            f"If you didn't request this, ignore this mail.\n")

    async def send_password_reset_confirmation(self, to_email: str) -> bool:
        settings = self._ctx.settings
        return await self.send(
            to_email,
            f"{settings.app_name}: password changed",
            f"The password for {to_email} was just changed.\n"
            f"If this wasn't you, contact your administrator immediately.\n")
