"""The wire API: the aiohttp app (``app.py``) and its server entry point
(``python -m swarmdb_tpu_torch.api.server``)."""
