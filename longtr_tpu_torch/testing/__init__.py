"""Fixture builders: synthetic genomes, BAMs and catalogs made from a seed."""
