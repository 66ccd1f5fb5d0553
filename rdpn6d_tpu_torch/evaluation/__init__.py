"""ADD / ADI / re / te / proj pose errors."""
