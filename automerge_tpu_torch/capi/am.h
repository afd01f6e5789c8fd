/* automerge_tpu_torch C ABI — the analogue of the reference's automerge-c
 * frontend (reference: rust/automerge-c/src/doc.rs, result.rs, item.rs).
 *
 * Memory model: every operation returns an AMresult owning a sequence of
 * tagged AMitems; the caller frees it with am_result_free. Strings and
 * byte spans returned by item accessors are owned by the result and live
 * until it is freed. Documents and sync states are opaque handles freed
 * with their own destructors.
 *
 * Call am_init() once before anything else (it boots the embedded
 * runtime; set AUTOMERGE_TPU_TORCH_PYROOT if the framework is not
 * importable from the default path, and PYTHONPATH to the directories that
 * hold torch and numpy), and am_shutdown() at exit. Documents live on the
 * device that AUTOMERGE_TPU_TORCH_DEVICE names: the CUDA card when it is
 * unset (a call that makes a document then fails without one), "cpu" for
 * the plain PyTorch path.
 */
#ifndef AUTOMERGE_TPU_AM_H
#define AUTOMERGE_TPU_AM_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct AMdoc AMdoc;
typedef struct AMresult AMresult;
typedef struct AMsyncState AMsyncState;

typedef enum {
  AM_STATUS_OK = 0,
  AM_STATUS_ERROR = 1,
} AMstatus;

/* Matches automerge_tpu_torch/capi/shim.py item tags. */
typedef enum {
  AM_VAL_VOID = 0,
  AM_VAL_NULL = 1,
  AM_VAL_BOOL = 2,
  AM_VAL_INT = 3,
  AM_VAL_UINT = 4,
  AM_VAL_F64 = 5,
  AM_VAL_STR = 6,
  AM_VAL_BYTES = 7,
  AM_VAL_COUNTER = 8,
  AM_VAL_TIMESTAMP = 9,
  AM_VAL_OBJ_ID = 10,
} AMvalType;

typedef enum {
  AM_OBJ_MAP = 0,
  AM_OBJ_LIST = 1,
  AM_OBJ_TEXT = 2,
  AM_OBJ_TABLE = 3,
} AMobjType;

#define AM_ROOT "_root"

/* -- runtime ------------------------------------------------------------- */
int am_init(void);
void am_shutdown(void);

/* -- document lifecycle (see also am_create/am_load/am_fork below) -------- */
/* Same history AND same actor id (am_fork mints a fresh actor). */
AMdoc *am_clone(AMdoc *doc);

/* -- results / items ------------------------------------------------------ */
AMstatus am_result_status(const AMresult *r);
const char *am_result_error(const AMresult *r); /* NULL when OK */
size_t am_result_size(const AMresult *r);
AMvalType am_item_type(const AMresult *r, size_t i);
int64_t am_item_int(const AMresult *r, size_t i); /* INT/UINT/COUNTER/TIMESTAMP/BOOL */
double am_item_f64(const AMresult *r, size_t i);
const char *am_item_str(const AMresult *r, size_t i); /* STR / OBJ_ID */
const uint8_t *am_item_bytes(const AMresult *r, size_t i, size_t *len);
void am_result_free(AMresult *r);

/* -- documents ------------------------------------------------------------ */
AMdoc *am_create(const uint8_t *actor, size_t actor_len); /* NULL on error */
AMdoc *am_load(const uint8_t *data, size_t len);
AMdoc *am_fork(AMdoc *doc, const uint8_t *actor, size_t actor_len);
void am_doc_free(AMdoc *doc);

AMresult *am_save(AMdoc *doc);                       /* item: BYTES */
AMresult *am_commit(AMdoc *doc, const char *message); /* item: BYTES hash (or empty) */
AMresult *am_merge(AMdoc *doc, AMdoc *other);         /* items: BYTES hashes */
AMresult *am_get_heads(AMdoc *doc);                   /* items: BYTES */
AMresult *am_actor_id(AMdoc *doc);                    /* item: BYTES */
AMresult *am_set_actor_id(AMdoc *doc, const uint8_t *actor, size_t actor_len);
/* History-heads equality after autocommit (reference AMequal,
 * automerge-c doc.rs:42-44): identical content with different histories
 * compares NOT equal. For content equality use am_equal_content. */
AMresult *am_equal(AMdoc *doc, AMdoc *other);         /* item: BOOL */
/* Current-content equality (hydrated trees; histories may differ). */
AMresult *am_equal_content(AMdoc *doc, AMdoc *other); /* item: BOOL */
/* Uncommitted op count / discard the open transaction (count discarded). */
AMresult *am_pending_ops(AMdoc *doc);                 /* item: UINT */
AMresult *am_rollback(AMdoc *doc);                    /* item: UINT */

/* -- map / list mutation --------------------------------------------------- */
AMresult *am_map_put_null(AMdoc *doc, const char *obj, const char *key);
AMresult *am_map_put_bool(AMdoc *doc, const char *obj, const char *key, int v);
AMresult *am_map_put_int(AMdoc *doc, const char *obj, const char *key, int64_t v);
AMresult *am_map_put_uint(AMdoc *doc, const char *obj, const char *key, uint64_t v);
AMresult *am_map_put_f64(AMdoc *doc, const char *obj, const char *key, double v);
AMresult *am_map_put_str(AMdoc *doc, const char *obj, const char *key, const char *v);
AMresult *am_map_put_bytes(AMdoc *doc, const char *obj, const char *key,
                           const uint8_t *v, size_t len);
AMresult *am_map_put_counter(AMdoc *doc, const char *obj, const char *key, int64_t v);
AMresult *am_map_put_timestamp(AMdoc *doc, const char *obj, const char *key, int64_t v);
AMresult *am_map_put_object(AMdoc *doc, const char *obj, const char *key,
                            AMobjType t); /* item: OBJ_ID */
AMresult *am_map_delete(AMdoc *doc, const char *obj, const char *key);
AMresult *am_map_increment(AMdoc *doc, const char *obj, const char *key, int64_t by);

AMresult *am_list_put_null(AMdoc *doc, const char *obj, size_t index);
AMresult *am_list_put_bool(AMdoc *doc, const char *obj, size_t index, int v);
AMresult *am_list_put_int(AMdoc *doc, const char *obj, size_t index, int64_t v);
AMresult *am_list_put_uint(AMdoc *doc, const char *obj, size_t index, uint64_t v);
AMresult *am_list_put_f64(AMdoc *doc, const char *obj, size_t index, double v);
AMresult *am_list_put_str(AMdoc *doc, const char *obj, size_t index, const char *v);
AMresult *am_list_put_bytes(AMdoc *doc, const char *obj, size_t index,
                            const uint8_t *v, size_t len);
AMresult *am_list_put_counter(AMdoc *doc, const char *obj, size_t index, int64_t v);
AMresult *am_list_put_timestamp(AMdoc *doc, const char *obj, size_t index, int64_t v);
AMresult *am_list_put_object(AMdoc *doc, const char *obj, size_t index,
                             AMobjType t); /* item: OBJ_ID */
AMresult *am_list_insert_null(AMdoc *doc, const char *obj, size_t index);
AMresult *am_list_insert_bool(AMdoc *doc, const char *obj, size_t index, int v);
AMresult *am_list_insert_int(AMdoc *doc, const char *obj, size_t index, int64_t v);
AMresult *am_list_insert_uint(AMdoc *doc, const char *obj, size_t index, uint64_t v);
AMresult *am_list_insert_f64(AMdoc *doc, const char *obj, size_t index, double v);
AMresult *am_list_insert_str(AMdoc *doc, const char *obj, size_t index, const char *v);
AMresult *am_list_insert_bytes(AMdoc *doc, const char *obj, size_t index,
                               const uint8_t *v, size_t len);
AMresult *am_list_insert_counter(AMdoc *doc, const char *obj, size_t index, int64_t v);
AMresult *am_list_insert_timestamp(AMdoc *doc, const char *obj, size_t index,
                                   int64_t v);
AMresult *am_list_insert_object(AMdoc *doc, const char *obj, size_t index,
                                AMobjType t); /* item: OBJ_ID */
AMresult *am_list_delete(AMdoc *doc, const char *obj, size_t index);
AMresult *am_list_increment(AMdoc *doc, const char *obj, size_t index, int64_t by);

/* -- text ------------------------------------------------------------------ */
AMresult *am_splice_text(AMdoc *doc, const char *obj, size_t pos, size_t del,
                         const char *text);
AMresult *am_text(AMdoc *doc, const char *obj); /* item: STR */

/* -- reads ----------------------------------------------------------------- */
AMresult *am_map_get(AMdoc *doc, const char *obj, const char *key);
AMresult *am_map_get_all(AMdoc *doc, const char *obj, const char *key);
AMresult *am_list_get(AMdoc *doc, const char *obj, size_t index);
AMresult *am_keys(AMdoc *doc, const char *obj);   /* items: STR */
AMresult *am_length(AMdoc *doc, const char *obj); /* item: UINT */
/* item: UINT AMobjType code */
AMresult *am_object_type(AMdoc *doc, const char *obj);
/* one value/OBJ_ID item per visible element */
AMresult *am_list_items(AMdoc *doc, const char *obj);
/* per entry: STR key then the value item (2 items each) */
AMresult *am_map_entries(AMdoc *doc, const char *obj);
/* value items for visible indices in [start, end) */
/* end = SIZE_MAX means unbounded (reference AMlistRange convention). */
AMresult *am_list_range(AMdoc *doc, const char *obj, size_t start, size_t end);
/* (STR key, value item) pairs for keys in [begin, end); "" end = unbounded */
AMresult *am_map_range(AMdoc *doc, const char *obj, const char *begin,
                       const char *end);
/* delete ``del`` elements at ``pos`` (AMsplice's delete side; insertions
 * go through the typed am_list_insert_* calls) */
AMresult *am_list_splice(AMdoc *doc, const char *obj, size_t pos, size_t del);

/* -- historical reads (*_at) ----------------------------------------------- */
/* ``heads`` = n_heads concatenated 32-byte change hashes (the bytes of
 * am_get_heads items back to back) — the reference's *_at read surface
 * (reference: rust/automerge/src/read.rs parents_at/keys_at/...). */
AMresult *am_map_get_at(AMdoc *doc, const char *obj, const char *key,
                        const uint8_t *heads, size_t n_heads);
AMresult *am_map_get_all_at(AMdoc *doc, const char *obj, const char *key,
                            const uint8_t *heads, size_t n_heads);
AMresult *am_list_get_at(AMdoc *doc, const char *obj, size_t index,
                         const uint8_t *heads, size_t n_heads);
AMresult *am_keys_at(AMdoc *doc, const char *obj, const uint8_t *heads,
                     size_t n_heads);
AMresult *am_length_at(AMdoc *doc, const char *obj, const uint8_t *heads,
                       size_t n_heads);
AMresult *am_text_at(AMdoc *doc, const char *obj, const uint8_t *heads,
                     size_t n_heads);
AMresult *am_marks_at(AMdoc *doc, const char *obj, const uint8_t *heads,
                      size_t n_heads);
/* Fork pinned at historical heads (reference: automerge.rs fork_at). */
AMdoc *am_fork_at(AMdoc *doc, const uint8_t *heads, size_t n_heads,
                  const uint8_t *actor, size_t actor_len);

/* -- patches ---------------------------------------------------------------- */
/* Both return flat 6-item records per patch:
 *   STR obj exid | STR path ("key/3/sub") | STR kind | STR prop |
 *   UINT index-or-length | value item (VOID when the kind carries none)
 * kinds: put_map put_seq insert splice_text del_map del_seq increment
 * flag_conflict mark_clear mark mark_end. Insert emits one record per
 * inserted value. Mark changes use replace-all framing: one mark_clear
 * record for the object, then per surviving span a ("mark", name, start,
 * value) record paired with a ("mark_end", name, end, VOID) record —
 * replace the object's marks with the set between mark_clear records.
 * Patch value items carry counter values as INT (the materialized
 * number); read accessors (am_map_get &c.) are the source of
 * counter-ness. */
AMresult *am_diff(AMdoc *doc, const uint8_t *before, size_t n_before,
                  const uint8_t *after, size_t n_after);
/* Patches since the last pop; the first call activates the observer log
 * at the current heads and returns an empty result. */
AMresult *am_pop_patches(AMdoc *doc);

/* -- marks / cursors ------------------------------------------------------- */
/* expand: "none" | "before" | "after" | "both" (reference ExpandMark). */
AMresult *am_mark_str(AMdoc *doc, const char *obj, size_t start, size_t end,
                      const char *name, const char *value, const char *expand);
AMresult *am_mark_bool(AMdoc *doc, const char *obj, size_t start, size_t end,
                       const char *name, int value, const char *expand);
AMresult *am_unmark(AMdoc *doc, const char *obj, size_t start, size_t end,
                    const char *name);
/* items per mark: UINT start, UINT end, STR name, then the value item */
AMresult *am_marks(AMdoc *doc, const char *obj);
AMresult *am_get_cursor(AMdoc *doc, const char *obj, size_t pos); /* item: STR */
AMresult *am_get_cursor_position(AMdoc *doc, const char *obj,
                                 const char *cursor); /* item: UINT */

/* -- history exchange ------------------------------------------------------ */
/* Apply raw change/document chunk bytes (a peer's save_incremental output). */
AMresult *am_apply_changes(AMdoc *doc, const uint8_t *data, size_t len);
/* Change chunks not covered by the given 32-byte head hashes (concatenated
 * AMresult BYTES items from am_get_heads); item: BYTES. */
AMresult *am_save_incremental(AMdoc *doc, const uint8_t *heads, size_t n_heads);
/* Raw change chunks not reachable from the given heads; items: BYTES. */
AMresult *am_get_changes(AMdoc *doc, const uint8_t *heads, size_t n_heads);
/* One raw change chunk by its 32-byte hash (empty result = unknown). */
AMresult *am_get_change_by_hash(AMdoc *doc, const uint8_t *hash);
/* Raw change chunks present in ``other`` but absent from ``doc`` — what a
 * merge of ``other`` into ``doc`` would apply. */
AMresult *am_get_changes_added(AMdoc *doc, AMdoc *other);
/* The author's most recent change (commits pending ops first). */
AMresult *am_get_last_local_change(AMdoc *doc);       /* BYTES or empty */
/* Dependency hashes referenced but not yet applied (the causal queue's
 * wait set), given additional target heads. */
AMresult *am_get_missing_deps(AMdoc *doc, const uint8_t *heads, size_t n_heads);

/* -- sync ------------------------------------------------------------------ */
AMsyncState *am_sync_state_new(void);
void am_sync_state_free(AMsyncState *s);
AMresult *am_generate_sync_message(AMdoc *doc, AMsyncState *s); /* BYTES or empty */
AMresult *am_receive_sync_message(AMdoc *doc, AMsyncState *s, const uint8_t *msg,
                                  size_t len);
/* Persistable sync-state codec (reference: sync/state.rs encode/decode —
 * only shared_heads survive the roundtrip, by design). */
AMresult *am_sync_state_encode(AMsyncState *s); /* item: BYTES */
AMsyncState *am_sync_state_decode(const uint8_t *data, size_t len);
/* Heads both peers are known to share (BYTES items). */
AMresult *am_sync_state_shared_heads(AMsyncState *s);

#ifdef __cplusplus
}
#endif
#endif /* AUTOMERGE_TPU_AM_H */
