"""Datasets and the device-resident ray pipeline of the port."""
