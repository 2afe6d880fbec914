"""Version of the unicycler_tpu_torch port (a copy of
unicycler_tpu/version.py).

Capability parity target: Unicycler 0.5.1 (reference unicycler/version.py:16).
"""

__version__ = '0.1.0'
