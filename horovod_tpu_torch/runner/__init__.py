"""Launcher-side pieces of the port. Only the rendezvous KV client is here;
the KV server and the elastic driver wait for ROADMAP A15 (the JAX
package's driver, ``python -m horovod_tpu.runner``, runs port workers)."""
