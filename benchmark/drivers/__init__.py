"""The drivers of the traffic mixes, one file each, found by the mix's ``driver``."""
