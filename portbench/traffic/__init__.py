"""Traffic mixes (``<name>.json``, data) and the drivers that run them
(``<kind>.py``): a mix names its driver by ``kind``, and
``common.driver`` imports ``portbench.traffic.<kind>``."""
