"""Independence-Metropolis correction of flow samples."""
