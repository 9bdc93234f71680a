"""Launcher-side pieces of the port: the rendezvous KV client and
``KVStoreServer`` (``http_server.py``) and the crash-safe journal
(``journal.py``). The rendezvous server and the elastic driver wait for
ROADMAP A15 (the JAX package's driver, ``python -m horovod_tpu.runner``,
runs port workers)."""
