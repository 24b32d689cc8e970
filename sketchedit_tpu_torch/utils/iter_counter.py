"""Step-based training clock with reference-compatible resume (a copy of
``sketchedit_tpu/utils/iter_counter.py``).

The trainer advances one optimizer STEP per G+D call — that is the
unit this clock counts. The reference's epoch x image-count view
(util/iter_counter.py persists "epoch,images" to iter.txt and expresses
every periodic frequency in images) survives only at the two boundaries
where compatibility matters:

* `iter.txt` keeps the exact on-disk "epoch,images" CSV so checkpoints
  written by either implementation resume in the other;
* the periodic predicates (`needs_printing` etc.) take their thresholds
  from the image-denominated `--*_freq` flags and fire on the step whose
  batch crosses each multiple, which is the reference trigger condition
  `images_so_far % freq < batchSize` expressed in steps.

Everything else is step-native: one counter, monotonic timing, properties
deriving the image view on demand.
"""

from __future__ import annotations

import os
import time


class IterationCounter:
    """Tracks (epoch, step-in-epoch) with image-denominated triggers."""

    def __init__(self, opt, dataset_size: int, record: bool = True):
        """``record`` False never writes iter.txt (a data-parallel rank
        other than 0 keeps the clock but leaves the file to rank 0)."""
        self.record = record
        self.batch_size = int(opt.batchSize)
        self.dataset_size = int(dataset_size)
        self.total_epochs = int(opt.niter) + int(
            getattr(opt, "niter_decay", 0))
        self._freqs = {
            "save": int(opt.save_latest_freq),
            "print": int(opt.print_freq),
            "display": int(opt.display_freq),
        }
        self._save_epoch_freq = int(opt.save_epoch_freq)
        self.iter_record_path = os.path.join(
            opt.checkpoints_dir, opt.name, "iter.txt")

        self.first_epoch = 1
        self.current_epoch = 1
        self._epoch_steps = 0            # optimizer steps into current epoch
        self.time_per_iter = 0.0         # seconds per IMAGE (printed as ms/img)
        self.time_per_epoch = 0.0

        if getattr(opt, "isTrain", False) and getattr(
                opt, "continue_train", False):
            resumed = self._read_record()
            if resumed is not None:
                self.first_epoch, images = resumed
                self._epoch_steps = images // self.batch_size
                print(f"Resuming from epoch {self.first_epoch} "
                      f"at iteration {images}")
            else:
                print(f"Could not load iteration record at "
                      f"{self.iter_record_path}. Starting from beginning.")
        self._global_step = ((self.first_epoch - 1) * self._steps_per_epoch
                             + self._epoch_steps)
        # reference resume semantics (util/iter_counter.py:16-23): the
        # image total restarts at (first_epoch-1) * dataset_size + images,
        # NOT steps*batch — they differ when dataset_size % batchSize != 0,
        # and the image-denominated periodic triggers must keep the
        # reference's phase across a resume
        self._init_step = self._global_step
        self._images_base = ((self.first_epoch - 1) * self.dataset_size
                             + self._epoch_steps * self.batch_size)
        self._t_last = self._t_epoch = time.monotonic()

    # -- derived views -----------------------------------------------------

    @property
    def _steps_per_epoch(self) -> int:
        return max(1, self.dataset_size // self.batch_size)

    @property
    def epoch_iter(self) -> int:
        """Images consumed in the current epoch (reference's unit)."""
        return self._epoch_steps * self.batch_size

    @property
    def total_steps_so_far(self) -> int:
        """Images consumed overall — kept image-denominated because every
        `--*_freq` flag and the reference's own counter speak images."""
        return (self._images_base
                + (self._global_step - self._init_step) * self.batch_size)

    # -- persistence (reference iter.txt format: "epoch,images") -----------

    def _read_record(self):
        try:
            with open(self.iter_record_path) as fh:
                text = fh.read()
            epoch, images = (int(float(tok)) for tok in
                             text.replace(",", "\n").split())
            return epoch, images
        except (OSError, ValueError):
            return None

    def _write_record(self, epoch: int, images: int):
        if not self.record:
            return
        with open(self.iter_record_path, "w") as fh:
            fh.write(f"{epoch}\n{images}\n")
        print(f"Saved current iteration count at {self.iter_record_path}.")

    def record_current_iter(self):
        self._write_record(self.current_epoch, self.epoch_iter)

    # -- loop hooks ---------------------------------------------------------

    def training_epochs(self):
        return range(self.first_epoch, self.total_epochs + 1)

    def record_epoch_start(self, epoch: int):
        self.current_epoch = epoch
        self._t_epoch = self._t_last = time.monotonic()

    def record_one_iteration(self):
        now = time.monotonic()
        self.time_per_iter = (now - self._t_last) / self.batch_size
        self._t_last = now
        self._global_step += 1
        self._epoch_steps += 1

    def record_epoch_end(self):
        self.time_per_epoch = time.monotonic() - self._t_epoch
        print(f"End of epoch {self.current_epoch} / {self.total_epochs} \t "
              f"Time Taken: {self.time_per_epoch:.0f} sec")
        if self.current_epoch % self._save_epoch_freq == 0:
            self._write_record(self.current_epoch + 1, 0)
        self._epoch_steps = 0

    # -- periodic triggers (image-denominated flags, step-native firing) ----

    def _crossed(self, freq_images: int) -> bool:
        """True on the step whose batch crossed a multiple of freq_images
        (the reference condition: images % freq < batchSize)."""
        return (self.total_steps_so_far % freq_images) < self.batch_size

    def needs_saving(self) -> bool:
        return self._crossed(self._freqs["save"])

    def needs_printing(self) -> bool:
        return self._crossed(self._freqs["print"])

    def needs_displaying(self) -> bool:
        return self._crossed(self._freqs["display"])
