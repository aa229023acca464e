"""Carried over from termdaw_tpu/config.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Project configuration: `project.toml` parsing with reference defaults.

Mirrors the reference config surface (reference config.rs:19-76, doc.md:26-34):

    [project]
    name = "..."            # optional, default "unnamed"

    [settings]
    main = "project.lua"    # required
    buffer_length = 1024    # optional, default 1024
    project_samplerate = 44100  # optional, default 44100
    workflow = "manual"     # optional, "manual" | "stream", default manual

Parsed with the stdlib `tomllib` (the reference uses serde+toml,
config.rs:14). Like the reference (`Config::read` unwraps, config.rs:10-17),
a missing or malformed file raises.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path


class WorkFlow(Enum):
    MANUAL = "manual"
    STREAM = "stream"

    def __str__(self) -> str:  # reference config.rs:40-47
        return self.value


@dataclass
class Project:
    name: str = "unnamed"  # reference config.rs:30-34


@dataclass
class Settings:
    main: str = "project.lua"
    buffer_length: int = 1024          # reference config.rs:58-60
    project_samplerate: int = 44100    # reference config.rs:62-64
    workflow: WorkFlow = WorkFlow.MANUAL  # reference config.rs:66-75


@dataclass
class Config:
    project: Project = field(default_factory=Project)
    settings: Settings = field(default_factory=Settings)

    @staticmethod
    def read(path: str | Path) -> "Config":
        """Read and parse `project.toml`. Raises on missing/bad file, like
        the reference's unwraps (config.rs:10-17)."""
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        return Config.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "Config":
        proj_raw = raw.get("project", {}) or {}
        set_raw = raw.get("settings", {}) or {}
        project = Project(name=proj_raw.get("name", "unnamed"))
        wf_str = set_raw.get("workflow")
        # Any string other than "stream" falls back to manual
        # (reference config.rs:66-75).
        workflow = WorkFlow.STREAM if wf_str == "stream" else WorkFlow.MANUAL
        if "main" not in set_raw:
            raise KeyError("project.toml: [settings] must define `main`")
        settings = Settings(
            main=set_raw["main"],
            buffer_length=int(set_raw.get("buffer_length", 1024)),
            project_samplerate=int(set_raw.get("project_samplerate", 44100)),
            workflow=workflow,
        )
        return Config(project=project, settings=settings)
