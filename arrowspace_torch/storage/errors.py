"""Typed storage errors (reference: storage/mod.rs:11-34)."""

from __future__ import annotations


class StorageError(Exception):
    """Base storage error with a kind tag mirroring the Rust enum."""

    def __init__(self, kind: str, message: str):
        self.kind = kind  # "Io" | "Parquet" | "Arrow" | "Invalid"
        super().__init__(f"{kind}: {message}")

    @staticmethod
    def io(msg: str) -> "StorageError":
        return StorageError("Io", msg)

    @staticmethod
    def parquet(msg: str) -> "StorageError":
        return StorageError("Parquet", msg)

    @staticmethod
    def arrow(msg: str) -> "StorageError":
        return StorageError("Arrow", msg)

    @staticmethod
    def invalid(msg: str) -> "StorageError":
        return StorageError("Invalid", msg)
