"""Host-side pipeline stages (bwamem.c equivalents).

These run on CPU in both the oracle pipeline and the TPU production
pipeline (SURVEY.md §1: L4 maps to host-side orchestration); only
seeding and extension move to the device.
"""
