"""Mapping artifacts and platforms (``repro.api`` counterparts)."""
from repro_torch.api.artifact import SCHEMA_VERSION, MappingArtifact
from repro_torch.api.platforms import Platform

__all__ = ["MappingArtifact", "Platform", "SCHEMA_VERSION"]
