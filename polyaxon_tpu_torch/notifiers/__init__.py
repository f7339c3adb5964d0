from polyaxon_tpu_torch.notifiers.service import (
    FileNotifier,
    Notifier,
    NotificationService,
    PagerDutyNotifier,
    SlackNotifier,
    WebhookNotifier,
)

__all__ = [
    "FileNotifier",
    "NotificationService",
    "Notifier",
    "PagerDutyNotifier",
    "SlackNotifier",
    "WebhookNotifier",
]
