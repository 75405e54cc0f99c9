"""Services of the port: ``base`` (``AppContext``, the domain errors),
``diagnostics_service`` (a live engine's state and its ``torch.profiler``
capture) and ``llm_provider_service`` (the ``llm_providers`` table wired
into the app's provider registry)."""
