from collide.alerts.extract import AlertBatch, extract_alerts, compute_priority
from collide.alerts.manager import AlertManager
