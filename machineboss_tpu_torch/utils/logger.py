"""Leveled logging with per-function tags and progress reporting
(ref: src/logger.{h,cpp}: -v N levels, -d func tags, ANSI color, progress
with ETA). Used by the CLI and long-running host operations."""

import sys
import time

_ANSI = {"reset": "\033[0m", "dim": "\033[2m", "green": "\033[32m",
         "yellow": "\033[33m"}


class Logger:
    def __init__(self):
        self.verbosity = 2
        self.tags = set()
        self.color = True

    def parse_args(self, verbose=None, debug_tags=None, monochrome=False):
        if verbose is not None:
            self.verbosity = int(verbose)
        if debug_tags:
            self.tags.update(debug_tags)
        if monochrome:
            self.color = False

    def logging_at(self, level, tag=None):
        return level <= self.verbosity or (tag and tag in self.tags)

    def log(self, level, msg, tag=None):
        if self.logging_at(level, tag):
            if self.color:
                sys.stderr.write(_ANSI["dim"] + msg + _ANSI["reset"] + "\n")
            else:
                sys.stderr.write(msg + "\n")

    def progress(self, level, description):
        return ProgressLog(self, level, description)


class ProgressLog:
    """Progress reporting with percentage and ETA (ref ProgressLog)."""

    def __init__(self, logger, level, description):
        self.logger = logger
        self.level = level
        self.description = description
        self.start = time.time()
        self.last = 0.0

    def update(self, fraction, detail=""):
        now = time.time()
        if now - self.last < 1.0 or not self.logger.logging_at(self.level):
            return
        self.last = now
        elapsed = now - self.start
        eta = elapsed / fraction - elapsed if fraction > 0 else float("inf")
        self.logger.log(self.level,
                        "%s: %.1f%% (ETA %.0fs) %s"
                        % (self.description, 100 * fraction, eta, detail))


logger = Logger()
