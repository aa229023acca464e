"""Carried over from termdaw_tpu/banks/bufferbank.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

BufferBank: named raw byte blobs (wavetables etc.).

Mirrors reference bufferbank.rs:11-83 including mark-dead + compacting
refresh.
"""

from __future__ import annotations


class BufferBank:
    def __init__(self) -> None:
        self.buffers: list[bytes] = []
        self.names: dict[str, int] = {}
        self.marked: set[int] = set()

    def add(self, name: str, file_path: str) -> None:
        if name in self.names:
            raise ValueError(
                f'BufferBank: there is already a blob with name "{name}" present.'
            )
        try:
            with open(file_path, "rb") as f:
                buffer = f.read()
        except OSError:
            raise ValueError(
                f'BufferBank: could not read file "{file_path}".'
            ) from None
        self.buffers.append(buffer)
        self.names[name] = len(self.buffers) - 1

    def mark_dead(self, name: str) -> None:
        idx = self.names.get(name)
        if idx is not None:
            self.marked.add(idx)

    def refresh(self) -> None:
        if not self.marked:
            return
        new_map: dict[str, int] = {}
        new_vec: list[bytes] = []
        for name, index in self.names.items():
            if index in self.marked:
                continue
            new_vec.append(self.buffers[index])
            new_map[name] = len(new_vec) - 1
        self.names = new_map
        self.buffers = new_vec
        self.marked.clear()

    def get_index(self, name: str) -> int | None:
        return self.names.get(name)

    def get_buffer(self, index: int) -> bytes:
        return self.buffers[index]
