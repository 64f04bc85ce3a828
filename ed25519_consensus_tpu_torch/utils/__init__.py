"""Support utilities: conformance fixtures."""
