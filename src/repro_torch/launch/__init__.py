"""The launch path of the port (``repro.launch``): the single-card train
step (``steps``) and its launcher (``train``)."""
