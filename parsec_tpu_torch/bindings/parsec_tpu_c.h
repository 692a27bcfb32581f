/* C embedding API for the parsec_tpu_torch runtime — the reference's
 * second-language bindings analog (ref: parsec/fortran/parsecf.F90:
 * init/fini, taskpool create/wait, profiling wrappers for F90 programs).
 * Here the host runtime is Python, so the foreign language is C/C++: this
 * header + libparsec_tpu_c let a C program initialize the runtime, build
 * a DTD taskpool, insert tasks whose bodies are C function pointers over
 * raw tile buffers, and wait for completion.
 *
 * Build: compile parsec_tpu_c.c against libpython (python3-config
 * --includes --embed --ldflags); or call
 * python -m parsec_tpu_torch.bindings.build to produce libparsec_tpu_c.so
 * under build/bindings/.  ptc_init puts the device module on cuda:0, as
 * init() does: without a card it fails unless
 * PARSEC_MCA_device_cuda_platform=cpu is set.
 *
 * Threading: call all ptc_* functions from the thread that called
 * ptc_init (it owns the embedded interpreter's main state). Task bodies
 * run on runtime worker threads; the runtime marshals tile buffers in and
 * out around each call.
 */
#ifndef PARSEC_TPU_C_H
#define PARSEC_TPU_C_H

#ifdef __cplusplus
extern "C" {
#endif

typedef struct ptc_context ptc_context;
typedef struct ptc_taskpool ptc_taskpool;
typedef struct ptc_tile ptc_tile;

/* Tile access modes (ref: PARSEC_INPUT/OUTPUT/INOUT). */
enum { PTC_INPUT = 0, PTC_OUTPUT = 1, PTC_INOUT = 2 };

/* A task body: tiles[i] points at tile i's elements (row-major float32,
 * rows*cols elements, writable for OUTPUT/INOUT). */
typedef void (*ptc_body_fn)(float **tiles, int ntiles, void *user);

/* Runtime lifecycle. Returns NULL on failure. nb_cores <= 0 = default. */
ptc_context *ptc_init(int nb_cores);
void ptc_fini(ptc_context *ctx);

/* DTD taskpool lifecycle. The handle stays valid (and ptc_taskpool_wait
 * may be retried on failure) until ptc_taskpool_free. */
ptc_taskpool *ptc_dtd_taskpool_new(ptc_context *ctx);
int ptc_taskpool_wait(ptc_taskpool *tp);          /* 0 on success */
int ptc_data_flush_all(ptc_taskpool *tp);         /* 0 on success */
void ptc_taskpool_free(ptc_taskpool *tp);

/* Wrap caller-owned row-major float32 data as a tracked tile. The buffer
 * must outlive the taskpool; after ptc_data_flush_all + wait it holds the
 * final values. */
ptc_tile *ptc_tile_of_dense(ptc_taskpool *tp, float *data,
                            long rows, long cols);
/* Release a tile handle (after the owning taskpool completed). */
void ptc_tile_free(ptc_tile *tile);

/* Insert one task: fn(tile buffers..., user) with per-tile access modes
 * driving dependency discovery. Returns 0 on success. */
int ptc_insert_task(ptc_taskpool *tp, ptc_body_fn fn, void *user,
                    int ntiles, ptc_tile **tiles, const int *modes);

/* Last error message ("" when none), version string. */
const char *ptc_last_error(void);
const char *ptc_version(void);

/* The context's devices, comma-separated ("cpu,cuda:0"); valid until
 * the next call. NULL on failure. */
const char *ptc_device_names(ptc_context *ctx);

#ifdef __cplusplus
}
#endif
#endif /* PARSEC_TPU_C_H */
