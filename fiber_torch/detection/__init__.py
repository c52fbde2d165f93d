"""Grounding detection: fusion backbone, FPN, VLDyHead, ATSS postprocess."""
