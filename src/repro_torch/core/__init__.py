"""Formats, limbs, policy, context, dispatch and the public ops."""
