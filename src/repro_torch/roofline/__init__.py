"""The H100's published rates and each kernel's byte and operation model
(the port's counterpart of ``repro.roofline.analysis``'s hardware
constants and byte models; ``hlo_parse.py`` has no counterpart, as the
port compiles no HLO). ``h100`` is the one owner of these numbers:
``chip_smoke.py``'s bounds and the analyzer's INFO findings read it."""
