"""The call that the port's CLI makes once its indexes are loaded
(tophat_tpu_torch/cli/main._run): the paired streaming pipeline over
two FASTQ files, the single-end streaming pipeline over one, each
parsing its FASTQ in batches of `--batch-size` reads."""

import os


def run(world, fastq, out_dir, log):
    from tophat_tpu_torch.pipeline.run import iter_read_batches

    p, w = world.params, world
    batches = lambda f: iter_read_batches([f], p.quals_scale, p.batch_size,
                                          integer_quals=p.integer_quals)
    if len(fastq) == 2:
        from tophat_tpu_torch.pipeline.paired import (
            run_pipeline_paired_streaming)
        run_pipeline_paired_streaming(
            w.genome, zip(batches(fastq[0]), batches(fastq[1])), p, out_dir,
            fm=w.fm, known_events=w.known, gtf_accept=w.gtf_accept,
            trans=w.trans, log=log, device=w.device)
    else:
        from tophat_tpu_torch.pipeline.run import run_pipeline_streaming
        run_pipeline_streaming(
            w.genome, batches(fastq[0]), p, out_dir, fm=w.fm,
            known_events=w.known, gtf_accept=w.gtf_accept, trans=w.trans,
            tmp_dir=os.path.join(out_dir, "tmp"), log=log, device=w.device)
