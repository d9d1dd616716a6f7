"""The traffic kinds, one module each, found by the ``kind`` a traffic file
names (``traffic/<mix>.json``): ``kinds/<kind>.py`` holds the ``Driver``
that sets up (its ``setup_phases``: seconds of each phase, printed to
standard error) and drives the port's entry point for that kind, the
``check`` that compares what its window produced with the plain
reference, and the faults (``FAULTS``, ``fault_patches``) that the tests
plant under it.
"""
