"""Runtime lock watchdog (copy of ``repro.analysis.lock_watchdog``)."""
